"""From a profiled stretch of steps to what the per-layer metrics read.

`records` turns torch.profiler's raw event list into plain tuples; the
rest works on those tuples, so the arithmetic is tested on synthetic
events. On the device, kernels, copies and fills are work; the ranges
that `record_function` draws on the device's timeline (`Optimizer.step`,
`ProfilerStep#`, this harness's step ranges) are not, and counting them
would count their kernels twice.
"""
from __future__ import annotations

import bisect
from typing import NamedTuple, Optional

TOP = 10
LONGEST = 2000
#: the host range around the harness's own per-step work (its draws)
HARNESS_RANGE = "perfbench.step_draws"
#: host calls that each put one operation on the device's stream
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
            "cudaMemsetAsync")


class Ev(NamedTuple):
    """One event: `kind` is "kernel", "memcpy", "memset", "annotation"
    (device) or "host"; times in nanoseconds."""
    kind: str
    name: str
    start: int
    end: int


def _device_kind(name: str, annotation: bool) -> str:
    if annotation or name.startswith("ProfilerStep#"):
        return "annotation"
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def records(kineto_events) -> list:
    """Ev tuples from `prof.profiler.kineto_results.events()`, walked once
    (building the profiler's own event tree takes minutes at a million
    events)."""
    from torch.autograd import DeviceType
    out = []
    for e in kineto_events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            ann = bool(getattr(e, "is_user_annotation", lambda: False)())
            out.append(Ev(_device_kind(e.name(), ann), e.name(), start, end))
        else:
            out.append(Ev("host", e.name(), start, end))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_at(host: list, starts: list, t: int) -> str:
    """The innermost host event open at time t (the latest-started one
    still open), else the one that ended last before t; among the 5,000
    host events that started last before t."""
    i = bisect.bisect_right(starts, t) - 1
    last: Optional[Ev] = None
    for j in range(i, max(-1, i - 5000), -1):
        h = host[j]
        if h.end >= t:
            return h.name
        if last is None or h.end > last.end:
            last = h
    return last.name if last is not None else "(none)"


def reduce(evs: list) -> dict:
    """The stretch's device work: its length (first device work to last),
    busy seconds (the union of kernel, copy and fill intervals), kernel
    count, seconds by kernel name, and the idle gaps' seconds by what the
    host was doing in them."""
    work = [e for e in evs if e.kind in ("kernel", "memcpy", "memset")]
    harness = harness_share(evs)
    if not work:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": 0,
                "by_kernel": {}, "idle_by_host": {}, "harness": harness}
    merged = _merge([(e.start, e.end) for e in work])
    busy = sum(e - s for s, e in merged)
    window = merged[-1][1] - merged[0][0]
    by_kernel: dict = {}
    for e in work:
        c, ns = by_kernel.get(e.name, (0, 0))
        by_kernel[e.name] = (c + 1, ns + e.end - e.start)
    host = sorted((e for e in evs if e.kind == "host"),
                  key=lambda h: h.start)
    starts = [h.start for h in host]
    idle: dict = {}
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    # the longest gaps are attributed one by one; the many short ones
    # between kernels share one line
    gaps.sort(key=lambda g: g[0] - g[1])
    for i, (s, e) in enumerate(gaps):
        name = (_host_at(host, starts, (s + e) // 2) if i < LONGEST
                else "(gaps shorter than the longest 2000)")
        idle[name] = idle.get(name, 0) + (e - s)
    return {"window_s": window / 1e9, "busy_s": busy / 1e9,
            "kernels": sum(1 for e in work if e.kind == "kernel"),
            "by_kernel": {k: (c, ns / 1e9) for k, (c, ns) in
                          by_kernel.items()},
            "idle_by_host": {k: ns / 1e9 for k, ns in idle.items()},
            "harness": harness}


def harness_share(evs: list) -> dict:
    """The harness's own work in the stretch: host seconds inside its
    ranges, and the device operations launched from inside them."""
    ranges = sorted((e.start, e.end) for e in evs
                    if e.kind == "host" and e.name == HARNESS_RANGE)
    starts = [s for s, _ in ranges]
    launches = 0
    for e in evs:
        if e.kind == "host" and e.name in LAUNCHES:
            i = bisect.bisect_right(starts, e.start) - 1
            if i >= 0 and e.start <= ranges[i][1]:
                launches += 1
    return {"ranges": len(ranges),
            "host_s": sum(b - a for a, b in ranges) / 1e9,
            "launches": launches}


def breakdown(red: dict) -> dict:
    """The ten device operations that took the most time, and the ten
    host activities under which the device sat idle longest."""
    ops = sorted(((k[:200], s) for k, (_, s) in red["by_kernel"].items()),
                 key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(((k[:200], s) for k, s in red["idle_by_host"].items()),
                  key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [list(o) for o in ops],
            "idle_gaps": [list(g) for g in gaps]}


def idle_share(red: dict) -> Optional[float]:
    if red["window_s"] <= 0:
        return None
    return 1.0 - red["busy_s"] / red["window_s"]


def kernel_time(red: dict, fragment: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    `fragment`."""
    n, s = 0, 0.0
    for name, (c, sec) in red["by_kernel"].items():
        if fragment in name:
            n, s = n + c, s + sec
    return n, s
