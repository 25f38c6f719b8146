"""Shared fixtures of the benchmark's own tests (run them with
`python -m pytest perfbench/tests`; the card-only ones carry the `cuda`
marker and skip without a card)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORKLOADS = ["u1_flagship.train", "su3_8x8_b57.train", "su3_8x8_b57.draw",
             "u1_flagship.hmc"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
