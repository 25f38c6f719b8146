"""The CUDA force kernels against their plain PyTorch versions, on the card.

Skips on a machine without CUDA. Imports no JAX, so it also runs where the
JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_u1_force_cuda.py
"""
import numpy as np
import pytest
import torch

from l2hmc_torch.ops.kernels import u1_force as tk

torch.set_num_threads(1)


def _x(seed, dtype, nb, nt, nx):
    rng = np.random.default_rng(seed)
    return rng.uniform(-3.0, 3.0, (nb, 2 * nt * nx)).astype(dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check on "
                    "the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    x = torch.from_numpy(_x(8, np.float64, 37, 8, 12)).to(
        cuda_device, dtype)
    f, a = tk.force_action(x, 4.0, 8, 12)
    fp, ap = tk.force_action_plain(x, 4.0, 8, 12)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(f, fp, atol=tol, rtol=0)
    torch.testing.assert_close(a, ap, atol=0, rtol=tol)
    g = torch.randn_like(x)
    gs = torch.randn(37, dtype=dtype, device=cuda_device)
    b = tk.force_action_bwd(x, g, gs, f, 4.0, 8, 12)
    bp = tk.force_action_bwd_plain(x, g, gs, f, 4.0, 8, 12)
    torch.testing.assert_close(b, bp, atol=1e-4 if dtype == torch.float32
                               else 1e-10, rtol=0)
