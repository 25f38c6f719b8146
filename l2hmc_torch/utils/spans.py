"""Spans and counters of the step path.

A span marks one layer boundary (PERF.md §3 lists them):

    TRANSITION = spans.span("transition")
    ...
    with TRANSITION:
        xout, metrics = dynamics.apply_transition_fb(...)

- **Host.** While a torch.profiler records, a span opens a
  `record_function` range of its name, so the profiler's trace (and the
  idle gaps read from it) names the host work on the device trace's clock,
  and it adds its host duration to an aggregate per (job, span path):
  count, total and self nanoseconds, and its duration in each step (at
  most `MAX_STEPS` of them), from which medians are read. The path is the
  nesting of the spans open around it, joined by "/".
- **Capture.** While `capture` is open around a CUDA-graph capture,
  profiler or not, a span records where its device operations start and
  end in the graph: the capture's node count at its enter and at its
  exit. A step body runs on the host only when it is captured, and
  replays skip it, so this costs nothing per replay.
- **Otherwise** a span does nothing but two checks.

`count(name, n)` adds to a per-job integer counter, always. `job(name)`
(a context manager and a decorator) names the job of the spans and
counters inside it. `summary()` returns the aggregate and the counters,
`reset()` clears them. Nothing is written to disk: the profiler's trace is
the timeline.

The spans of one process share one stack, not one per thread: autograd
runs a CUDA backward on a thread of its own while the thread that called
`backward()` waits, so the spans the backward opens (a recomputed
checkpointed step) nest inside the `backward` span that waits for them.
"""
from __future__ import annotations

import ctypes
import functools
import statistics
import time
from contextlib import ContextDecorator, contextmanager
from types import SimpleNamespace
from typing import Callable, Optional

from torch.autograd import profiler as _profiler

#: per-step durations kept for each (job, path)
MAX_STEPS = 1 << 16
#: the key of what no span covers, and the job outside any `job`
NONE = "(none)"
#: the span whose exit ends a step of the per-step durations
STEP = "trainer.step"
#: CUgraphNodeType: CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
WORK_NODE_TYPES = frozenset((0, 1, 2))


class _Agg:
    __slots__ = ("parent", "count", "total_ns", "self_ns", "steps", "cur")

    def __init__(self, parent: Optional[str]):
        self.parent = parent
        self.count = self.total_ns = self.self_ns = 0
        self.steps: list = []
        #: ns in the step in progress; None: none yet
        self.cur: Optional[int] = None


_job: Optional[str] = None
_jobs: list = []
_counts: dict = {}
_aggs: dict = {}
#: open host spans: [span, job, path, t0_ns, child_ns, record_function]
_host: list = []
#: aggregates with time in the step in progress
_touched: list = []
_capture: Optional["Capture"] = None
_spans: dict = {}


class Span:
    """One named span; `span(name)` returns the one of that name."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _capture is not None:
            _capture.enter(self)
        if _profiler._is_profiler_enabled:
            _host_enter(self)
        return self

    def __exit__(self, *exc):
        if _capture is not None:
            _capture.exit(self)
        if _host and _host[-1][0] is self:
            _host_exit()
        return False

    def __call__(self, fn):
        """As a decorator: each call of fn runs inside the span. The
        wrapper holds fn's arguments through the call, so a function that
        lets a large input go early opens the span in its body instead."""
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return inner


def span(name: str) -> Span:
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = Span(name)
    return s


class job(ContextDecorator):
    """Names the job (train, eval, hmc, warmup) of the spans and counters
    inside it; the previous job is back on exit."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _job
        _jobs.append(_job)
        _job = self.name
        return self

    def __exit__(self, *exc):
        global _job
        _job = _jobs.pop()
        return False


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the current job."""
    key = (_job, name)
    _counts[key] = _counts.get(key, 0) + n


def _host_enter(s: Span) -> None:
    path = _host[-1][2] + "/" + s.name if _host else s.name
    rf = _profiler.record_function(s.name)
    rf.__enter__()
    _host.append([s, _job, path, time.perf_counter_ns(), 0, rf])


def _host_exit() -> None:
    s, jb, path, t0, child, rf = _host.pop()
    dur = time.perf_counter_ns() - t0
    rf.__exit__(None, None, None)
    if _host:
        _host[-1][4] += dur
    key = (jb, path)
    agg = _aggs.get(key)
    if agg is None:
        agg = _aggs[key] = _Agg(path.rpartition("/")[0] or None)
    agg.count += 1
    agg.total_ns += dur
    agg.self_ns += dur - child
    if agg.cur is None:
        agg.cur = 0
        _touched.append(agg)
    agg.cur += dur
    # a step's spans are summed over the step; a span outside any step is
    # a step of its own
    if s.name == STEP or not any(f[0].name == STEP for f in _host):
        for a in _touched:
            if len(a.steps) < MAX_STEPS:
                a.steps.append(a.cur)
            a.cur = None
        _touched.clear()


def summary() -> dict:
    """{"spans": {job: {path: {"parent", "count", "total_ns", "self_ns",
    "median_ns", "steps"}}}, "counters": {job: {name: n}}}; the job
    outside any `job` is "(none)". "steps" holds the span's duration in
    each step (ns), "median_ns" their median."""
    spans_out: dict = {}
    for (jb, path), a in _aggs.items():
        spans_out.setdefault(jb or NONE, {})[path] = {
            "parent": a.parent, "count": a.count, "total_ns": a.total_ns,
            "self_ns": a.self_ns,
            "median_ns": statistics.median(a.steps) if a.steps else None,
            "steps": list(a.steps)}
    counters: dict = {}
    for (jb, name), n in _counts.items():
        counters.setdefault(jb or NONE, {})[name] = n
    return {"spans": spans_out, "counters": counters}


def reset() -> None:
    """Clear the aggregate and the counters (open spans stay open)."""
    _counts.clear()
    _aggs.clear()
    _touched.clear()


# ----------------------------------------------------------------------
# Capture-time attribution
# ----------------------------------------------------------------------
class Capture:
    """The spans of one graph capture: `nodes()` is the capture's node
    count so far, `kinds(n)` whether each of its first n nodes is a device
    operation (a kernel, copy or fill node; None: every node is one).
    Paths are relative to the capture."""

    def __init__(self, nodes: Callable[[], int],
                 kinds: Optional[Callable[[int], list]] = None):
        self.nodes, self.kinds = nodes, kinds
        self.stack: list = []
        self.done: list = []
        self.stats: dict = {}

    def enter(self, s: Span) -> None:
        path = self.stack[-1][1] + "/" + s.name if self.stack else s.name
        self.stack.append((s, path, self.nodes()))

    def exit(self, s: Span) -> None:
        if self.stack and self.stack[-1][0] is s:
            _, path, n0 = self.stack.pop()
            self.done.append((path, n0, self.nodes()))

    def finish(self) -> dict:
        """{"ops", "span_ops", "span_ranges"}: the graph's device
        operations, each span path's inclusive operations ("(none)": those
        in no span), and each path's [first, last) operation ordinals, one
        pair per time the span was entered."""
        n = self.nodes()
        work = self.kinds(n) if self.kinds is not None else [True] * n
        ordinal = [0]
        for w in work:
            ordinal.append(ordinal[-1] + bool(w))
        span_ops: dict = {}
        ranges: dict = {}
        for path, a, b in self.done:
            lo, hi = ordinal[a], ordinal[b]
            span_ops[path] = span_ops.get(path, 0) + hi - lo
            ranges.setdefault(path, []).append([lo, hi])
        top = sum(v for p, v in span_ops.items() if "/" not in p)
        span_ops[NONE] = ordinal[n] - top
        self.stats = {"ops": ordinal[n], "span_ops": span_ops,
                      "span_ranges": ranges}
        return self.stats


@contextmanager
def capture(graph):
    """Around a step body inside a CUDA-graph capture of `graph`: the
    spans inside it record their device operations; on a clean exit the
    yielded Capture's `stats` holds them (`Capture.finish`). The node
    count comes from `graph_nodes(graph)`, which a test may replace."""
    global _capture
    cap = Capture(*graph_nodes(graph))
    prev, _capture = _capture, cap
    try:
        yield cap
    finally:
        _capture = prev
    cap.finish()


# ----------------------------------------------------------------------
# The capture's node count on the card, through libcuda (ctypes)
# ----------------------------------------------------------------------
_libcuda_api = None


def _libcuda():
    """libcuda's capture and graph queries, typed (ctypes), from the
    library torch has loaded."""
    global _libcuda_api
    if _libcuda_api is not None:
        return _libcuda_api
    lib = ctypes.CDLL("libcuda.so.1")
    vp, sz, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    p = ctypes.POINTER
    # (stream, status, id, graph, dependencies, count of dependencies)
    info = lib.cuStreamGetCaptureInfo_v2
    info.argtypes = [vp, p(i), p(ctypes.c_ulonglong), p(vp), vp, vp]
    info.restype = i
    get, kind = lib.cuGraphGetNodes, lib.cuGraphNodeGetType
    get.argtypes, get.restype = [vp, p(vp), p(sz)], i
    kind.argtypes, kind.restype = [vp, p(i)], i
    _libcuda_api = SimpleNamespace(
        capture_info=lambda *a: info(*a, None, None), get_nodes=get,
        node_type=kind)
    return _libcuda_api


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUresult {rc}")


def graph_nodes(graph):
    """(nodes, kinds) of the capture in progress on the current CUDA
    stream (`graph` is the torch.cuda.CUDAGraph it captures into): nodes()
    its node count so far, kinds(n) whether each of its first n nodes is
    a kernel, copy or fill node."""
    import torch
    lib = _libcuda()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    status, cid = ctypes.c_int(), ctypes.c_ulonglong()
    g = ctypes.c_void_p()
    _check(lib.capture_info(stream, ctypes.byref(status),
                            ctypes.byref(cid), ctypes.byref(g)),
           "cuStreamGetCaptureInfo")
    if status.value != 1:          # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("spans.capture outside a stream capture")
    n = ctypes.c_size_t()
    get = lib.get_nodes

    def nodes() -> int:
        _check(get(g, None, ctypes.byref(n)), "cuGraphGetNodes")
        return n.value

    def kinds(count: int) -> list:
        arr = (ctypes.c_void_p * count)()
        got = ctypes.c_size_t(count)
        _check(get(g, arr, ctypes.byref(got)), "cuGraphGetNodes")
        t = ctypes.c_int()
        out = []
        for node in arr[:got.value]:
            _check(lib.node_type(node, ctypes.byref(t)),
                   "cuGraphNodeGetType")
            out.append(t.value in WORK_NODE_TYPES)
        return out

    return nodes, kinds
