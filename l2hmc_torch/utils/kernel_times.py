"""Times of the U(1) force kernels on one CUDA card, beside their bounds.

    python -m l2hmc_torch.utils.kernel_times [--against DIR]

For each kernel (forward, backward with gS, backward without) at the
main-path shape (2048 x 2x16x16 float32) and at 64x64 (512 chains,
float32 and float64) it prints one JSON line with four times per launch:

  events_ms   CUDA events around 200 back-to-back wrapper calls (median of
              5 such batches): what a Python caller sees, the host's
              enqueue rate included;
  device_ms   torch.profiler's device time of the kernel alone;
  graph_ms    replay of a CUDA graph of 17 launches: the kernel with the
              host out of the way, launch gaps included;
  cold_*      device_ms and graph_ms again while rotating over enough
              distinct inputs to exceed the 50 MB L2 (the outputs, which
              the wrappers allocate, come from the allocator's cache and
              may stay resident);

and the bytes the call must move with the time the card's memory rate
allows for them; and the forward once more on an input that starts one
element off 16-byte alignment (`fwd_off_alignment`), which the kernel
serves with ordinary loads, one site a thread and runtime nx: beside `fwd`
it shows what bulk copies, 16-byte accesses and a compile-time nx buy.

`--against DIR` names another checkout of this repository (for example
`git archive` of the parent commit): its kernels are built from its own
sources and timed in turn with this one's, in the order other, this, this,
other, inside one process on one card.

The last line is the host's share: microseconds per call, on the host's
clock, of the whole forward wrapper and of its parts (checks, the two
allocations, pointer and stream lookups, the ctypes launch alone).

`chip_smoke.py` uses the same functions for its time phases.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

#: H100 SXM data sheet: HBM rate, float32 and float64 rates outside the
#: tensor cores (dense), at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
L2_BYTES = 50e6
#: operations per lattice site (sin and cos counted one each): forward
#: W (3), sin, cos, 1 - cos, the action sum, 2 subs + 2 muls of the force;
#: backward W (3), A gF (3), cos, the product, 2 subs, 2 muls, 2 fmas
OPS_PER_SITE = {"fwd": 11, "bwd": 15, "bwd_no_gs": 13,
                "fwd_off_alignment": 11}
#: full (nb, 2 V) tensors each call reads or writes, and (nb,) vectors
TENSORS = {"fwd": (2, 1), "bwd": (4, 1), "bwd_no_gs": (3, 0),
           "fwd_off_alignment": (2, 1)}
#: launches per captured graph: one trajectory's force evaluations
GRAPH_LAUNCHES = 17
#: operations of one complex 3x3 matrix product (27 complex multiply-adds),
#: and the products a link of the SU(3) force kernel: six staples of two,
#: and U A
SU3_PRODUCT_OPS, SU3_FORCE_PRODUCTS = 216, 13
#: products a matrix of the SU(3) link kernels: expm at order 8 with two
#: squarings (7 Taylor terms, 2 squarings), reunit (x^ x, two
#: Newton-Schulz steps of 3, x y; the first step needs none)
SU3_LINK_PRODUCTS = {"su3_expm_fwd": 9, "su3_reunit_fwd": 8}


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def bytes_moved(kind: str, nb: int, nt: int, nx: int, size: int) -> int:
    """Each input read once, each output written once."""
    full, vec = TENSORS[kind]
    return (full * nb * 2 * nt * nx + vec * nb) * size


def bound(kind: str, nb: int, nt: int, nx: int, dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of the type, whichever is larger."""
    name = str(dtype).replace("torch.", "")
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = bytes_moved(kind, nb, nt, nx, size)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = OPS_PER_SITE[kind] * nb * nt * nx / PEAK_OPS_PER_S[name] * 1e3
    return {"bytes": nbytes, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def su3_force_bound(lat, nb: int, dtype) -> dict:
    """`bound` for one su3_force_fwd launch on `nb` chains of lattice
    `lat`: the links read and the force written once (18 values a link
    each) and the per-chain traces written; 13 products a link."""
    name = str(dtype).replace("torch.", "")
    size = torch.empty((), dtype=dtype).element_size()
    links = 4 * math.prod(lat) * nb
    nbytes = (2 * 18 * links + nb) * size
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = (SU3_FORCE_PRODUCTS * SU3_PRODUCT_OPS * links
              / PEAK_OPS_PER_S[name] * 1e3)
    return {"bytes": nbytes, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def su3_link_bound(name: str, lat, nb: int, dtype) -> dict:
    """`bound` for one launch of an SU(3) link kernel over the 4 V nb
    links of `nb` chains of lattice `lat`: each matrix read once and
    written once (18 values each); the kernel's products a matrix."""
    prec = str(dtype).replace("torch.", "")
    size = torch.empty((), dtype=dtype).element_size()
    links = 4 * math.prod(lat) * nb
    nbytes = 2 * 18 * links * size
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = (SU3_LINK_PRODUCTS[name] * SU3_PRODUCT_OPS * links
              / PEAK_OPS_PER_S[prec] * 1e3)
    return {"bytes": nbytes, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "ops_bound_ms": by_ops}


def ptxas_usage(text: str) -> dict:
    """{function: {"registers", "spill_stores", "spill_loads"}} from the
    output of nvcc -Xptxas -v (mangled names)."""
    usage: dict = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"entry function '([^']+)'|Function properties for "
                      r"(\S+)", line)
        if m:
            current = m.group(1) or m.group(2)
            usage.setdefault(current, {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[current].update(spill_stores=int(m.group(1)),
                                  spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[current]["registers"] = int(m.group(1))
    return usage


def cuda_ms(fn, reps: int, warmup: int = 5, batches: int = 1) -> float:
    """Mean time of fn over reps, between two CUDA events; with several
    batches the median of their means (a batch of short host-bound calls
    moves with whatever else the host's cores are doing)."""
    for _ in range(warmup):
        fn()
    means = []
    for _ in range(batches):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def profiled(fn, reps: int, warm: bool = True):
    """torch.profiler over reps calls of fn (after one warm call, unless
    the caller has made it)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def device_kernels(prof) -> dict:
    """{kernel name: (count, device us)} of the profiled window. The
    ranges that `record_function` draws on the device's timeline
    (`Optimizer.step#...` around the optimizer's kernels) are not
    kernels and are left out: counted, they add their kernels' time
    twice."""
    from torch.autograd import DeviceType
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


def raw_summary(prof) -> dict:
    """{"kernels": {name: (count, device us)}, "host": {name: (count, self
    us)}} of a profiled window, read from the profiler's raw event list.
    `key_averages()` builds a Python object tree per event and needs
    minutes for the ~10^6 events of one SU(3) train step; this walks the
    raw events once. A host event's self time is its duration less that
    of the events nested in it on the same thread."""
    from torch.autograd import DeviceType
    kernels: dict = {}
    by_thread: dict = {}
    for e in prof.profiler.kineto_results.events():
        ns = hasattr(e, "duration_ns")
        dur = e.duration_ns() / 1e3 if ns else e.duration_us()
        if e.device_type() == DeviceType.CUDA:
            c, us = kernels.get(e.name(), (0, 0.0))
            kernels[e.name()] = (c + 1, us + dur)
        else:
            start = e.start_ns() / 1e3 if ns else e.start_us()
            by_thread.setdefault(e.start_thread_id(), []).append(
                (start, -dur, e.name()))
    host: dict = {}
    for events in by_thread.values():
        events.sort()
        stack = []                      # [end, name, self us] of open events
        for start, neg_dur, name in events:
            while stack and stack[-1][0] <= start:
                _, done, self_us = stack.pop()
                c, us = host.get(done, (0, 0.0))
                host[done] = (c + 1, us + self_us)
            if stack:
                stack[-1][2] += neg_dur
            stack.append([start - neg_dur, name, -neg_dur])
        for _, done, self_us in stack:
            c, us = host.get(done, (0, 0.0))
            host[done] = (c + 1, us + self_us)
    return {"kernels": kernels, "host": host}


def device_ms(fn, reps: int) -> dict:
    """Device time and kernel count per call of fn, from the profiler. The
    profiler now and then drops a kernel's record (a count that is no
    multiple of reps): such a window is taken again, at most twice."""
    for _ in range(3):
        kern = device_kernels(profiled(fn, reps))
        count = sum(c for c, _ in kern.values())
        if count and count % reps == 0:
            break
    return {"device_ms_per_call": sum(us for _, us in kern.values())
            / reps / 1e3,
            "kernels_per_call": sum(c for c, _ in kern.values()) / reps}


def graph_replay(step, launches: int, replays: int = 50, uk=None):
    """Capture `launches` calls step(0), step(1), ... into one CUDA graph
    and replay it. Returns (ms per launch, the captured calls' outputs
    after a replay): the outputs let the caller hold replay against eager.
    With `uk` (a u1_force module that counts replays) its launch counters
    count each replay's launches, and not the capture's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm: build, load, one-time set-up
        step(0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    counts = uk is not None and hasattr(uk, "captured_launches")
    recorded = {}
    if counts:
        with uk.captured_launches() as recorded, torch.cuda.graph(graph):
            outs = [step(i) for i in range(launches)]
    else:
        with torch.cuda.graph(graph):
            outs = [step(i) for i in range(launches)]

    def replay():
        graph.replay()
        if counts:
            uk.count_replay(recorded)
    ms = cuda_ms(replay, replays, warmup=3) / launches
    return ms, outs


def beta_for(uk, beta: float, dtype):
    """beta as a checkout's wrapper takes it on the hot path: a device
    scalar where the kernel reads beta from device memory, else a
    number."""
    if hasattr(uk, "beta_operand"):
        return torch.full((), beta, dtype=dtype, device="cuda")
    return beta


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts one element into its buffer, so
    that its address is not a multiple of 16 bytes."""
    v = t.new_empty((t.numel() + 1,))[1:].view(t.shape)
    return v.copy_(t)


class Rotation:
    """`n` distinct input sets for one shape, and the three kernel calls
    over them: call(kind)(i) runs the kernel on set i mod n. With n sets
    that together exceed the L2, every call finds its inputs cold."""

    def __init__(self, uk, nb, nt, nx, dtype, n, beta=4.0, seed=0):
        dev = torch.device("cuda")
        gen = torch.Generator(dev).manual_seed(seed)
        beta = beta_for(uk, beta, dtype)
        self.uk, self.n, self.beta, self.nt, self.nx = uk, n, beta, nt, nx
        self.sets = []
        for _ in range(n):
            x = (torch.rand((nb, 2 * nt * nx), generator=gen, device=dev,
                            dtype=dtype) * 2 - 1) * math.pi
            gf = torch.randn(x.shape, generator=gen, device=dev, dtype=dtype)
            gs = torch.randn((nb,), generator=gen, device=dev, dtype=dtype)
            f, _ = uk.force_action(x, beta, nt, nx)
            self.sets.append((x, gf, gs, f))
        torch.cuda.synchronize()

    def call(self, kind: str):
        uk, b, nt, nx, sets, n = (self.uk, self.beta, self.nt, self.nx,
                                  self.sets, self.n)
        if kind == "fwd":
            return lambda i=0: uk.force_action(sets[i % n][0], b, nt, nx)
        if kind == "fwd_off_alignment":
            off = [offset_view(s[0]) for s in sets]
            return lambda i=0: uk.force_action(off[i % n], b, nt, nx)
        if kind == "bwd":
            return lambda i=0: uk.force_action_bwd(*sets[i % n], b, nt, nx)
        if kind == "bwd_no_gs":
            return lambda i=0: uk.force_action_bwd(
                sets[i % n][0], sets[i % n][1], None, None, b, nt, nx)
        raise ValueError(kind)

    def takes_no_gs(self) -> bool:
        """Whether this checkout's backward accepts an absent gS."""
        try:
            self.call("bwd_no_gs")()
        except (AttributeError, TypeError):
            return False
        return True


def counted(step):
    """step(i) over i = 0, 1, 2, ... as a call without arguments."""
    state = {"i": 0}

    def fn():
        out = step(state["i"])
        state["i"] += 1
        return out
    return fn


def measure(uk, nb, nt, nx, dtype, reps=200, dev_reps=50) -> dict:
    """All times of one checkout's kernels at one shape; see the module's
    docstring for the keys."""
    size = torch.empty((), dtype=dtype).element_size()
    # enough sets that the inputs of one round are three times the L2
    n_cold = max(2, math.ceil(3 * L2_BYTES / (2 * nb * 2 * nt * nx * size)))
    hot = Rotation(uk, nb, nt, nx, dtype, 1)
    cold = Rotation(uk, nb, nt, nx, dtype, n_cold)
    out = {"shape": [nb, 2 * nt * nx], "nt": nt, "nx": nx,
           "dtype": str(dtype).replace("torch.", ""), "cold_sets": n_cold,
           "kernels": {}}
    kinds = ["fwd", "fwd_off_alignment", "bwd"] \
        + (["bwd_no_gs"] if hot.takes_no_gs() else [])
    for kind in kinds:
        row = dict(bound(kind, nb, nt, nx, dtype))
        row["events_ms"] = cuda_ms(hot.call(kind), reps, batches=5)
        row["device_ms"] = device_ms(hot.call(kind), dev_reps)[
            "device_ms_per_call"]
        row["graph_ms"], _ = graph_replay(hot.call(kind), GRAPH_LAUNCHES,
                                          uk=uk)
        row["cold_device_ms"] = device_ms(counted(cold.call(kind)),
                                          max(dev_reps, 2 * n_cold))[
            "device_ms_per_call"]
        row["cold_graph_ms"], _ = graph_replay(cold.call(kind), n_cold,
                                               uk=uk)
        out["kernels"][kind] = row
    return out


def host_us(fn, n: int = 3000, batches: int = 5) -> float:
    """Host microseconds per call of fn (median over batches of n calls,
    the device drained before and after each batch)."""
    res = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        res.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(res)


def host_split(uk, nb=2048, nt=16, nx=16) -> dict:
    """What a forward wrapper call costs on the host, and its parts."""
    x = torch.rand((nb, 2 * nt * nx), device="cuda")
    b = beta_for(uk, 4.0, x.dtype)
    f, a = uk.force_action(x, b, nt, nx)
    g = torch.randn_like(x)
    gs = torch.randn_like(a)
    fwd = uk._FWD[x.dtype]
    args = (x.data_ptr(), f.data_ptr(), a.data_ptr(), b.data_ptr(), nb, nt,
            nx, x.device.index, uk._raw_stream(x))
    n = nb * 2 * nt * nx

    def one_allocation():
        buf = x.new_empty((n + nb,))
        return buf[:n].view(x.shape), buf[n:]
    return {key: host_us(fn) for key, fn in [
        ("fwd", lambda: uk.force_action(x, b, nt, nx)),
        ("fwd_beta_number", lambda: uk.force_action(x, 4.0, nt, nx)),
        ("bwd", lambda: uk.force_action_bwd(x, g, gs, f, b, nt, nx)),
        ("bwd_no_gs", lambda: uk.force_action_bwd(x, g, None, None, b, nt,
                                                  nx)),
        ("checks", lambda: uk._check_cuda("u1_force_fwd", x, nt, nx,
                                          uk.FWD_WORDS)),
        ("beta_device_scalar", lambda: uk.beta_operand(b, x)),
        ("beta_number", lambda: uk.beta_operand(4.0, x)),
        ("empty_like", lambda: torch.empty_like(x)),
        ("new_empty_nb", lambda: x.new_empty((nb,))),
        ("one_allocation_two_views", one_allocation),
        ("three_data_ptr", lambda: (x.data_ptr(), f.data_ptr(),
                                    a.data_ptr())),
        ("raw_stream", lambda: uk._raw_stream(x)),
        ("stream_object", lambda: torch.cuda.current_stream(
            x.device).cuda_stream),
        ("ctypes_launch_alone", lambda: fwd(*args))]}


def load_kernels(root: Path, name: str):
    """The u1_force module of the checkout at `root`, under another module
    name: it builds from that checkout's sources into that checkout."""
    path = root / "l2hmc_torch" / "ops" / "kernels" / "u1_force.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


SHAPES = [(2048, 16, 16, torch.float32), (512, 64, 64, torch.float32),
          (512, 64, 64, torch.float64)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose kernels are timed in turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from l2hmc_torch.ops.kernels import u1_force as this
    card = card_line()
    order = [("this", this)]
    if args.against is not None:
        other = load_kernels(args.against.resolve(), "u1_force_other")
        order = [("other", other), ("this", this), ("this", this),
                 ("other", other)]
    for nb, nt, nx, dtype in SHAPES:
        for turn, (label, uk) in enumerate(order):
            res = measure(uk, nb, nt, nx, dtype)
            print(json.dumps({"card": card, "checkout": label, "turn": turn,
                              **res}), flush=True)
    print(json.dumps({"card": card, "host_us_per_call": host_split(this)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
