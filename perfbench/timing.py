"""The measured window's arithmetic, and the marks it is read from.

A window is the start mark and one completion mark per step, all on the
device's stream, read after the window has closed. Its length runs from
the start to the last step's completion; a rate is every step over that
length; a step's interval is the time between its completion and the
previous one (the first step's from the start), so a stall between two
steps lands in an interval and in the tail.
"""
from __future__ import annotations

import math
import time


def window(start_ms: float, ends_ms: list) -> dict:
    """{"seconds", "intervals_ms"} from the start mark and the steps'
    completion marks (milliseconds on one clock)."""
    if not ends_ms:
        raise ValueError("a window needs at least one step")
    marks = [start_ms, *ends_ms]
    return {"seconds": (ends_ms[-1] - start_ms) / 1e3,
            "intervals_ms": [b - a for a, b in zip(marks, marks[1:])]}


def rate(work_per_step: float, nsteps: int, seconds: float) -> float:
    return work_per_step * nsteps / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def tail_ok(n: int, q: float, beyond: int = 10) -> bool:
    """Whether n samples leave at least `beyond` above the q-th
    percentile."""
    return n * (1.0 - q / 100.0) >= beyond


class CudaMarks:
    """Start and completion marks as CUDA events, made before the window
    so that none is created inside it."""

    def __init__(self, nsteps: int):
        import torch
        self._torch = torch
        self.start = torch.cuda.Event(enable_timing=True)
        self.ends = [torch.cuda.Event(enable_timing=True)
                     for _ in range(nsteps)]

    def mark_start(self):
        self.start.record()

    def mark(self, i: int):
        self.ends[i].record()

    def read(self, n: int) -> tuple[float, list]:
        self._torch.cuda.synchronize()
        return 0.0, [self.start.elapsed_time(e) for e in self.ends[:n]]


class HostMarks:
    """The same marks on the host's clock, for a rehearsal on the CPU,
    whose every operation has finished when it returns."""

    def __init__(self, nsteps: int):
        self.t0 = None
        self.ends = [None] * nsteps

    def mark_start(self):
        self.t0 = time.perf_counter()

    def mark(self, i: int):
        self.ends[i] = time.perf_counter()

    def read(self, n: int) -> tuple[float, list]:
        if self.t0 is None or None in self.ends[:n]:
            raise ValueError("a mark was never recorded")
        return 0.0, [(t - self.t0) * 1e3 for t in self.ends[:n]]
