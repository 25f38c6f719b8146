"""The step path's spans and counters (l2hmc_torch/utils/spans.py).

On the CPU:
- spans off (no profiler recording) record nothing and open no
  `record_function`; counters count all the same;
- under a CPU torch.profiler the span names are among its events, and
  `summary()` holds paths, parents, counts, self time and per-step
  durations that add up, for a hand-made nest and for the trainer's loops;
- `host_reads` and `steps` of short `train`, `evaluate` and `warmup` runs
  equal the reads their loops make, counted from `steps.log` and the
  draw loop's check interval.

On the card (`cuda` marker, skipped here), for the U(1) default width
(train) and SU(3) 4^4 (train, and eval with the flow): the operations a
capture attributes to each span equal the device operations launched
inside it by the eager twin's same step under the profiler (tied to the
spans by each launch's correlation id), and one profiled replay runs as
many device operations as the graph's `ops`.

The capture-time attribution on the CPU, through the stand-in graph, is in
tests/test_torch_graph_step.py. Runs without the JAX package:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from l2hmc_torch.configs import get_config
from l2hmc_torch.train.trainer import Trainer
from l2hmc_torch.utils import spans

torch.set_num_threads(1)

U1 = ["dynamics.nchains=4", "dynamics.latvolume=[4, 4]",
      "dynamics.nleapfrog=2", "network.units=[4]", "seed=3"]
A, B, C = spans.span("a"), spans.span("b"), spans.span("c")


def _busy(ns: int) -> None:
    t = time.perf_counter_ns()
    while time.perf_counter_ns() - t < ns:
        pass


def _nest(nsteps: int) -> None:
    """nsteps steps of trainer.step{a{b, b}, c} under job "t"."""
    with spans.job("t"):
        for _ in range(nsteps):
            with spans.span(spans.STEP):
                with A:
                    with B:
                        _busy(200_000)
                    with B:
                        _busy(200_000)
                    _busy(100_000)
                with C:
                    _busy(100_000)


def test_spans_off_record_nothing_and_counters_count(monkeypatch):
    spans.reset()

    def refuse(*a, **k):
        raise AssertionError("a span opened a record_function while off")
    monkeypatch.setattr(spans._profiler, "record_function", refuse)
    _nest(3)
    with spans.job("t"):
        spans.count("host_reads", 4)
        spans.count("host_reads")
        spans.count("steps")
    spans.count("steps", 2)
    s = spans.summary()
    assert s["spans"] == {}
    assert s["counters"] == {"t": {"host_reads": 5, "steps": 1},
                             spans.NONE: {"steps": 2}}
    assert spans._job is None
    spans.reset()
    assert spans.summary() == {"spans": {}, "counters": {}}


def test_spans_under_the_cpu_profiler_add_up():
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nest(3)
    names = {e.name for e in prof.events()}
    assert {spans.STEP, "a", "b", "c"} <= names
    got = spans.summary()["spans"]["t"]
    step, a, b = (spans.STEP, spans.STEP + "/a", spans.STEP + "/a/b")
    c = spans.STEP + "/c"
    assert set(got) == {step, a, b, c}
    assert [got[p]["parent"] for p in (step, a, b, c)] == [None, step, a,
                                                           step]
    assert [got[p]["count"] for p in (step, a, b, c)] == [3, 3, 6, 3]
    for p, children in ((step, (a, c)), (a, (b,)), (b, ()), (c, ())):
        g = got[p]
        assert g["self_ns"] == g["total_ns"] - sum(got[q]["total_ns"]
                                                   for q in children)
        # one duration a step: b's two calls are summed
        assert len(g["steps"]) == 3 and sum(g["steps"]) == g["total_ns"]
        assert min(g["steps"]) <= g["median_ns"] <= max(g["steps"])
    assert got[b]["median_ns"] >= 400_000
    assert got[a]["self_ns"] >= 3 * 100_000


def test_trainer_spans_under_the_cpu_profiler():
    """The loops' host spans and the eager step bodies' layer spans, by
    job and path."""
    tr = Trainer(get_config(U1 + ["steps.log=1"]), device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = tr.random_x(gen)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        x = tr.train(x, gen, nera=1, nepoch=2)
        tr.evaluate(gen, job_type="hmc", nsteps=2, x=x)
    got = spans.summary()["spans"]
    run = "trainer.step/trainer.run"
    for path in ("trainer.step", "trainer.step/trainer.draws", run,
                 run + "/transition", run + "/transition/networks",
                 run + "/transition/u1.force", run + "/loss",
                 run + "/backward", run + "/backward/networks",
                 run + "/optimizer", run + "/metrics",
                 "trainer.step/trainer.loop"):
        assert got["train"][path]["count"] >= 2, path
        assert len(got["train"][path]["steps"]) == 2, path
    for job in ("warmup", "hmc"):
        assert {"trainer.step", run + "/transition",
                run + "/transition/u1.force", run + "/metrics",
                "trainer.step/trainer.loop"} <= set(got[job]), job
        assert not any("networks" in p for p in got[job])
    # the draws' history is read after the loop, outside any step
    assert got["hmc"]["trainer.loop"]["count"] == 1
    assert got["hmc"]["trainer.step"]["count"] == 2


def _tensor_keys(metrics: dict) -> int:
    return sum(isinstance(v, torch.Tensor) for v in metrics.values())


@pytest.mark.parametrize("job", ["train", "eval", "hmc"])
def test_host_reads_and_steps_count_the_loops_reads(job):
    """Per job: one read per tensor a history update grabs, per mean read
    for the host logic (every check_interval = 10 draws, the last too:
    acc, and acc_mask where HMC tunes its step size), and none for a sync
    on the CPU; one step per iteration."""
    nlog, n = 3, 12
    tr = Trainer(get_config(U1 + [f"steps.log={nlog}"]), device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = tr.random_x(gen)
    spans.reset()
    if job == "train":
        tr.train(x, gen, nera=1, nepoch=n)
        keys = _tensor_keys(tr.train_step(x, 2.0, gen)[1])
        logged = [e for e in range(n) if e % nlog == 0 or e == n - 1]
        want = len(logged) * keys
    else:
        tr.evaluate(gen, job_type=job, nsteps=n, x=x,
                    dynamic_step_size=True)
        with torch.no_grad():
            keys = _tensor_keys(tr.eval_step(x, 2.0, gen)[1] if job == "eval"
                                else tr.hmc_step(x, 2.0, 0.1, gen)[1])
        checks = [s for s in range(n) if (s + 1) % 10 == 0 or s == n - 1]
        want = n * keys + len(checks) * (2 if job == "hmc" else 1)
    got = spans.summary()["counters"][job]
    assert got == {"steps": n, "host_reads": want}, (got, keys)


def test_warmup_counts_its_reads():
    """exact=True: the acceptance every 10 trajectories; else the
    plaquette after each one too (here the U(1) stop rule never fires at
    beta 8 from a random start within 12 trajectories)."""
    tr = Trainer(get_config(U1), device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = tr.random_x(gen)
    spans.reset()
    tr.warmup(x, 8.0, gen, nsteps=25, exact=True)
    assert spans.summary()["counters"]["warmup"] == {"steps": 25,
                                                     "host_reads": 2}
    spans.reset()
    tr.warmup(x, 8.0, gen, nsteps=12)
    assert spans.summary()["counters"]["warmup"] == {"steps": 12,
                                                     "host_reads": 13}


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------
BODY_SPANS = ("transition", "networks", "u1.force", "su3.force_and_traces",
              "su3.expm", "su3.reunit", "loss", "backward", "optimizer",
              "metrics", "flow")


def _profiled(fn):
    """The raw kineto events of fn() on the card (CPU and CUDA). A
    profile drops the first device operations it sees (up to 24 of a
    replay that came first; a second replay in the same profile was
    whole), so 100 small kernels run first."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(100):
            warm.add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return list(prof.profiler.kineto_results.events())


def _replayed(graph) -> list:
    """The device operations one profiled replay of graph runs."""
    from torch.autograd import DeviceType
    evs = _profiled(graph.replay)
    launches = {e.correlation_id() for e in evs
                if e.device_type() == DeviceType.CPU
                and e.name() == "cudaGraphLaunch"}
    return [w for w in _work(evs) if w.correlation_id() in launches]


def _is_work(e) -> bool:
    """A kernel, copy or fill on the device (not a range the profiler
    draws on the device's timeline)."""
    from torch.autograd import DeviceType
    if e.device_type() != DeviceType.CUDA:
        return False
    if getattr(e, "is_user_annotation", lambda: False)():
        return False
    return not (e.name().startswith("ProfilerStep#")
                or e.name() in BODY_SPANS or e.name().startswith("trainer."))


def _work(evs) -> list:
    return sorted((e for e in evs if _is_work(e)), key=lambda e: e.start_ns())


def _per_span_ops(evs, root: str) -> dict:
    """Inclusive device operations per span path under the host range
    `root` (the root's own path included), each operation tied to the
    span open where the host launched it (its correlation id), and the
    names of those operations; the ranges of every thread nest in
    time."""
    from torch.autograd import DeviceType
    host = [e for e in evs if e.device_type() == DeviceType.CPU]
    launch = {e.correlation_id(): e.start_ns() for e in host
              if e.correlation_id() and e.name().startswith("cu")}
    ranges = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.name()) for e in host
                     if e.name() in BODY_SPANS or e.name() == root),
                    key=lambda r: (r[0], -r[1]))
    marks = []
    for i, (s, e, _) in enumerate(ranges):
        marks += [(s, 0, i), (e, 2, i)]
    work = _work(evs)
    missing = [w.name() for w in work if w.correlation_id() not in launch]
    assert not missing, missing[:5]
    marks += [(launch[w.correlation_id()], 1, i)
              for i, w in enumerate(work)]
    marks.sort()
    stack, counts, names = [], {}, []
    for _, kind, i in marks:
        if kind == 0:
            name = ranges[i][2]
            stack.append(name if not stack else stack[-1] + "/" + name)
        elif kind == 2:
            stack.pop()
        elif stack and stack[0] == root:
            names.append(work[i].name())
            parts = stack[-1].split("/")
            for k in range(1, len(parts) + 1):
                p = "/".join(parts[:k])
                counts[p] = counts.get(p, 0) + 1
    return counts, names


def _kind(name: str) -> str:
    """A device operation's name, a copy's as "memcpy": a replay runs a
    graph's device-to-device copy nodes as copy kernels of other names."""
    return "memcpy" if name.lower().startswith("memcpy") else name


def _same_ops(replayed: list, eager: list) -> None:
    """The replay's device operations are the eager step's, by name."""
    from collections import Counter
    r = Counter(_kind(w.name()) for w in replayed)
    e = Counter(_kind(n) for n in eager)
    assert r == e, {"eager only": dict((e - r).most_common(8)),
                    "replay only": dict((r - e).most_common(8))}


def _under(counts: dict, root: str) -> dict:
    """The counts of the paths below `root`, relative to it, and what lies
    in no span below it as "(none)"."""
    out = {p[len(root) + 1:]: v for p, v in counts.items()
           if p.startswith(root + "/")}
    out[spans.NONE] = counts.get(root, 0) - sum(
        v for p, v in out.items() if "/" not in p)
    return out


def _cases():
    return {
        "u1_train": (get_config([]), "train", 2.0),
        "su3_train": (get_config([], group="SU3"), "train", 5.5),
        "su3_eval": (get_config(["flow_nsteps=2"], group="SU3"), "eval",
                     5.5),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["u1_train", "su3_train", "su3_eval"])
def test_capture_span_ops_equal_the_eager_twins_launches(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, job, beta = _cases()[case]
    tr = Trainer(cfg, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    x = tr.random_x(gen)
    step = (tr.train_step if job == "train"
            else lambda x_, b, g: tr.eval_step(x_, b, g))
    for _ in range(2):           # eager, then captured (and replayed)
        x, _ = step(x, beta, gen)
    (entry,) = [e for e in tr._graphs.values() if e.stats["job"] == job]
    stats = entry.stats
    twin = tr.twin(graphs=False)
    tstep = (twin.train_step if job == "train"
             else lambda x_, b, g: twin.eval_step(x_, b, g))
    y, _ = tstep(x, beta, gen)           # past the twin's first step
    evs = _profiled(lambda: tstep(y, beta, gen))
    counts, names = _per_span_ops(evs, "trainer.run")
    eager = _under(counts, "trainer.run")
    assert eager == stats["span_ops"], (eager, stats["span_ops"])
    assert sum(v for p, v in eager.items() if "/" not in p) == stats["ops"]
    assert stats["span_ops"][spans.NONE] < 0.05 * stats["ops"]
    replayed = _replayed(entry.graph)
    _same_ops(replayed, names)
    assert len(replayed) == stats["ops"]
    if case == "u1_train":
        # the ranges map onto the replay's operations by position
        where = {"u1_force_fwd": ("transition/u1.force", "backward/u1.force"),
                 "u1_force_bwd": ("backward",)}
        for kernel, paths in where.items():
            at = [i for i, w in enumerate(replayed) if kernel in w.name()]
            inside = {i for p in paths
                      for lo, hi in stats["span_ranges"][p]
                      for i in range(lo, hi)}
            assert at and set(at) <= inside, kernel
    if job == "eval":
        for _ in range(2):        # eager, then captured (and replayed)
            tr._flow_metrics(x)
        (flow,) = [e for e in tr._graphs.values()
                   if e.stats["job"] == "flow"]
        fevs = _profiled(lambda: twin._flow_observables(x))
        eager, names = _per_span_ops(fevs, "flow")
        want = {p: v for p, v in flow.stats["span_ops"].items()
                if p != spans.NONE}
        assert eager == want, (eager, want)
        assert flow.stats["span_ops"][spans.NONE] == 0
        replayed = _replayed(flow.graph)
        _same_ops(replayed, names)
        assert len(replayed) == flow.stats["ops"]
