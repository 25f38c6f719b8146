"""The readers of the program's spans and counters (metrics/*ops_per_step*,
host_us_per_step.draw, host_reads_per_step.*) on synthetic contexts: each
returns the number computed by hand, and None where it finds nothing to
read (a CPU rehearsal, a parent without spans)."""
import pytest

from perfbench import bench

TRAIN = [
    {"job": "hmc", "replays": 40, "ops": 100, "span_ops": {
        "transition": 90, "metrics": 10, "(none)": 0}},
    {"job": "train", "replays": 3, "ops": 1000, "span_ops": {
        "optimizer": 60, "transition": 500, "transition/networks": 200,
        "transition/su3.force_and_traces": 120,
        "transition/su3.expm": 30, "transition/su3.reunit": 20,
        "loss": 40, "backward": 380, "backward/networks": 90,
        "metrics": 15, "(none)": 5}},
    {"job": "train", "replays": 1, "ops": 1100, "span_ops": {
        "optimizer": 70, "transition": 600, "transition/networks": 300,
        "transition/su3.expm": 10, "loss": 40, "backward": 370,
        "metrics": 20, "(none)": 0}},
]
DRAW = [
    {"job": "hmc", "replays": 20, "ops": 50, "span_ops": {
        "transition": 40, "transition/su3.expm": 8, "metrics": 10,
        "(none)": 0}},
    {"job": "eval", "replays": 10, "ops": 300, "span_ops": {
        "transition": 280, "transition/networks": 60,
        "transition/su3.force_and_traces": 100,
        "transition/su3.expm": 20, "transition/su3.reunit": 10,
        "metrics": 20, "(none)": 0}},
    {"job": "flow", "replays": 9, "ops": 700, "span_ops": {
        "flow": 700, "flow/su3.force_and_traces": 400,
        "flow/su3.expm": 150, "flow/su3.reunit": 50, "(none)": 0}},
]
TRACE = {"window_s": 1.0, "busy_s": 0.5, "kernels": 4000,
         "by_kernel": {"k1": (3000, 0.3), "Memcpy DtoD": (900, 0.1),
                       "Memset": (300, 0.1)}}
REHEARSAL_TRACE = {"window_s": 0.0, "busy_s": 0.0, "kernels": 0,
                   "by_kernel": {}}


def _ctx(job, stats, trace=TRACE, steps=4):
    return {"job": job, "kind": "train" if job == "train" else "draw",
            "trace": trace, "traced_steps": steps, "graph_stats": stats}


def _summary(spans_by_job=None, counters=None):
    return {"spans": spans_by_job or {}, "counters": counters or {}}


@pytest.fixture
def program(monkeypatch):
    """Sets what l2hmc_torch.utils.spans.summary returns."""
    from l2hmc_torch.utils import spans

    def set_summary(value):
        monkeypatch.setattr(spans, "summary", lambda: value)
    set_summary(_summary())
    return set_summary


@pytest.mark.parametrize("name,job,stats,want", [
    ("networks_ops_per_step.train", "train", TRAIN,
     ((200 + 90) * 3 + 300) / 4),
    ("backward_ops_per_step.train", "train", TRAIN, (380 * 3 + 370) / 4),
    ("optimizer_ops_per_step.train", "train", TRAIN, (60 * 3 + 70) / 4),
    ("su3_ops_per_step.train", "train", TRAIN, ((120 + 30 + 20) * 3 + 10)
     / 4),
    ("su3_ops_per_step.draw", "eval", DRAW,
     ((100 + 20 + 10) * 10 + (400 + 150 + 50) * 9) / 10),
    ("flow_ops_per_step.draw", "eval", DRAW, 700 * 9 / 10),
    ("eager_ops_per_step.draw", "eval", DRAW,
     4200 / 4 - (300 * 10 + 700 * 9) / 10),
])
def test_graph_readers_by_hand(program, name, job, stats, want):
    read = bench.reader(name)
    assert read(_ctx(job, stats)) == pytest.approx(want, rel=1e-12)
    # a CPU rehearsal: no graphs, nothing traced
    assert read(_ctx(job, [], REHEARSAL_TRACE)) is None
    # a parent whose graphs carry no operation counts
    bare = [{k: v for k, v in g.items() if k not in ("ops", "span_ops")}
            for g in stats]
    assert read(_ctx(job, bare)) is None


def test_host_readers_by_hand(program):
    us = bench.reader("host_us_per_step.draw")
    reads = {k: bench.reader(f"host_reads_per_step.{k}")
             for k in ("train", "draw")}
    program(_summary(
        {"hmc": {"trainer.step": {"median_ns": 412_500.0},
                 "trainer.step/trainer.run": {"median_ns": 200_000.0}}},
        {"hmc": {"steps": 400, "host_reads": 3210},
         "warmup": {"steps": 20, "host_reads": 22},
         "train": {"steps": 250, "host_reads": 2 * 15 + 4}}))
    assert us(_ctx("hmc", [])) == 412.5
    assert reads["draw"](_ctx("hmc", [])) == 3210 / 400
    assert reads["train"](_ctx("train", [])) == 34 / 250
    # the wrong kind of cell, a job without counts, a CPU rehearsal
    assert us(_ctx("train", [])) is None
    assert reads["draw"](_ctx("train", [])) is None
    assert us(_ctx("eval", [])) is None
    assert reads["draw"](_ctx("eval", [])) is None
    assert us(_ctx("hmc", [], REHEARSAL_TRACE)) is None
    assert reads["train"](_ctx("train", [], REHEARSAL_TRACE)) is None
    program(_summary())
    assert us(_ctx("hmc", [])) is None
    assert reads["draw"](_ctx("hmc", [])) is None


def test_host_readers_without_the_spans_module(monkeypatch, program):
    """A parent checkout has no l2hmc_torch.utils.spans: None, no raise."""
    import sys

    import l2hmc_torch.utils
    program(_summary({"hmc": {"trainer.step": {"median_ns": 1e5}}},
                     {"train": {"steps": 2, "host_reads": 3}}))
    assert bench.reader("host_us_per_step.draw")(_ctx("hmc", [])) == 100.0
    monkeypatch.delattr(l2hmc_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "l2hmc_torch.utils.spans", None)
    assert bench.reader("host_us_per_step.draw")(_ctx("hmc", [])) is None
    assert bench.reader("host_reads_per_step.train")(
        _ctx("train", [])) is None
