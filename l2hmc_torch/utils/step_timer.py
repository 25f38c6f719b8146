"""Wall-clock step timing with leapfrog-eval normalization.

Counterpart of the reference's `StepTimer`
(reference src/l2hmc/utils/step_timer.py:71-137;
evals_per_step = nleapfrog (x2 when merge_directions) wired at
trainers/trainer.py:87-95). `get_eval_rate` yields the headline
chain-leapfrog-evals/sec throughput used in BASELINE.md.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np


class StepTimer:
    def __init__(self, evals_per_step: int = 1):
        self.evals_per_step = evals_per_step
        self.data: list[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.data.append(dt)
        return dt

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def get_eval_rate(self, evals_per_step: Optional[int] = None) -> dict:
        """Leapfrog evals/sec over recorded steps (step_timer.py:87-100)."""
        eps = evals_per_step or self.evals_per_step
        elapsed = float(np.sum(self.data))
        nsteps = len(self.data)
        nevals = eps * nsteps
        return {
            "nsteps": nsteps,
            "nevals": nevals,
            "elapsed": elapsed,
            "eval_rate": nevals / elapsed if elapsed > 0 else float("nan"),
            "step_rate": nsteps / elapsed if elapsed > 0 else float("nan"),
            "avg_step_time": elapsed / nsteps if nsteps else float("nan"),
        }

    def save_and_write(self, outdir: str, mode: str = "w") -> dict:
        """Dump raw step times + rates (step_timer.py:102-137)."""
        os.makedirs(outdir, exist_ok=True)
        rates = self.get_eval_rate()
        with open(os.path.join(outdir, "step_timer.json"), mode) as f:
            json.dump({"rates": rates, "data": self.data}, f)
        return rates
