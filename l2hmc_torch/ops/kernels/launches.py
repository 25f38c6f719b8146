"""Launch counts of the port's hand-written CUDA kernels, by kernel name.

Each wrapper adds one to its kernel's count per launch (`add`), so a run
can show that its work went through the kernels. A CUDA-graph capture
launches nothing: `captured()` takes the launches recorded during a
capture off the counts and keeps them, and `count_replay` adds them back
once per replay of that graph. The counts are plain ints on the host.
"""
from __future__ import annotations

from contextlib import contextmanager

_COUNTS: dict[str, int] = {}


def register(*names: str) -> None:
    """Give each kernel name a count (0) if it has none."""
    for name in names:
        _COUNTS.setdefault(name, 0)


def add(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def counts(*names: str) -> dict:
    """{name: launches} for `names`, or for every registered kernel."""
    return {k: _COUNTS[k] for k in (names or _COUNTS)}


def reset(*names: str) -> None:
    """Set the counts of `names` (of every kernel if none) to 0."""
    for k in names or list(_COUNTS):
        _COUNTS[k] = 0


@contextmanager
def captured():
    """Around a CUDA-graph capture: yields a dict that holds, on exit, the
    launches the capture recorded, by kernel (a kernel it did not launch
    is left out), and takes them off the counts (recording is not
    launching)."""
    before = dict(_COUNTS)
    recorded: dict = {}
    try:
        yield recorded
    finally:
        recorded.update({k: v - before.get(k, 0) for k, v in _COUNTS.items()
                         if v != before.get(k, 0)})
        for k in _COUNTS:
            _COUNTS[k] = before.get(k, 0)


def count_replay(recorded: dict) -> None:
    """Count the launches of one replay of a graph whose capture
    `captured()` recorded."""
    for k, v in recorded.items():
        _COUNTS[k] = _COUNTS.get(k, 0) + v
