"""The window's arithmetic and the trace's on synthetic marks and events:
a stall moves the rate and the tail, annotations are not busy."""
from perfbench import timing, trace
from perfbench.trace import Ev


def test_rate_and_tail_see_a_stall():
    ends = [10.0 * (i + 1) for i in range(400)]
    calm = timing.window(0.0, ends)
    assert calm["seconds"] == 4.0
    assert timing.rate(8, 400, calm["seconds"]) == 800.0
    assert timing.percentile(calm["intervals_ms"], 95) == 10.0
    # a 300 ms stall before each of 30 steps (more than 5 % of them)
    stalled = [e + 300.0 * min(30, i // 10) for i, e in enumerate(ends)]
    win = timing.window(0.0, stalled)
    assert win["seconds"] == 4.0 + 9.0
    assert timing.rate(8, 400, win["seconds"]) < 800.0 * 0.35
    assert timing.percentile(win["intervals_ms"], 95) == 310.0


def test_percentile_and_its_sample_count():
    vals = list(range(1, 201))
    assert timing.percentile(vals, 95) == 190
    assert timing.tail_ok(200, 95) and not timing.tail_ok(199, 95)


def test_busy_is_the_union_of_work_not_annotations():
    evs = [Ev("kernel", "a", 0, 10), Ev("kernel", "b", 5, 20),
           Ev("memcpy", "Memcpy DtoD", 30, 40),
           Ev("annotation", "Optimizer.step#Adam.step", 0, 100),
           Ev("kernel", "a", 90, 100),
           Ev("host", "aten::item", 40, 90),
           Ev("host", "cudaStreamSynchronize", 45, 85)]
    red = trace.reduce(evs)
    assert red["window_s"] == 100e-9
    assert red["busy_s"] == 40e-9
    assert red["kernels"] == 3
    assert abs(trace.idle_share(red) - 0.6) < 1e-12
    # the longest gap (40-90) is under the innermost host event open at
    # its midpoint; the gap 20-30 under none open, so the last to end
    assert red["idle_by_host"]["cudaStreamSynchronize"] == 50e-9
    assert trace.kernel_time(red, "a") == (2, 20e-9)
    b = trace.breakdown(red)
    assert b["device_ops"][0] == ["a", 20e-9]
    assert b["idle_gaps"][0][0] == "cudaStreamSynchronize"


def test_harness_share_counts_its_ranges_and_their_launches():
    evs = [Ev("host", trace.HARNESS_RANGE, 0, 100),
           Ev("host", "cudaLaunchKernel", 10, 20),
           Ev("host", "cudaLaunchKernel", 30, 40),
           Ev("host", "cudaGraphLaunch", 200, 300),
           Ev("host", "cudaLaunchKernel", 310, 320),
           Ev("host", trace.HARNESS_RANGE, 400, 450),
           Ev("host", "cudaMemcpyAsync", 420, 430),
           Ev("kernel", "a", 0, 500)]
    h = trace.reduce(evs)["harness"]
    assert h == {"ranges": 2, "host_s": 150e-9, "launches": 3}
    assert trace.harness_share([]) == {"ranges": 0, "host_s": 0.0,
                                       "launches": 0}


def test_device_kinds():
    assert trace._device_kind("ProfilerStep#3", False) == "annotation"
    assert trace._device_kind("perfbench", True) == "annotation"
    assert trace._device_kind("Memset (Device)", False) == "memset"
    assert trace._device_kind("Memcpy HtoD (Pageable -> Device)",
                              False) == "memcpy"
    assert trace._device_kind("void u1_force_fwd_kernel<float>", False) \
        == "kernel"


def _fake_run(cell, nchains, job):
    from types import SimpleNamespace
    return SimpleNamespace(job=job, nchains=nchains, spec=cell.spec,
                           times={"setup_s": 12.5}, ktrace=4,
                           graph_stats=[{"capture_s": 1.0,
                                         "instantiate_s": 0.5}])


def test_each_cell_reports_its_metrics_from_marks_and_a_trace():
    from perfbench import bench
    from perfbench.tests.conftest import WORKLOADS
    for name in WORKLOADS:
        cell = bench.load_cell(name)
        job = cell.traffic["job"]
        nb = cell.spec["chains"]["train" if job == "train" else "draw"]
        run = _fake_run(cell, nb, job)
        win = timing.window(0.0, [float(i + 1) for i in range(400)])
        m = bench.card_metrics(cell, run, win, 3 * 2 ** 30, None)
        assert set(m) == {e["name"] for e in cell.end_to_end}
        key = "train_evals_per_s" if job == "train" else "draw_evals_per_s"
        assert m[key]["value"] == nb * 8 * 400 / 0.4
        if "peak_mem_gib" in m:
            assert m["peak_mem_gib"]["value"] == 3.0
        assert m["setup_s"]["value"] == 12.5
        evs = [Ev("kernel", "void u1_force_fwd_kernel<float>", 0, 10 ** 6),
               Ev("kernel", "elementwise", 2 * 10 ** 6, 4 * 10 ** 6),
               Ev("host", "aten::copy_", 10 ** 6, 2 * 10 ** 6)]
        red = trace.reduce(evs)
        m = bench.card_metrics(cell, run, win, None, red)
        assert set(m) == {e["name"] for e in cell.per_layer}, name
        assert m["graph_setup_s"]["value"] == 1.5
        for k, v in m.items():
            if k.startswith(("mfu", "u1_force_roofline",
                             "device_idle_share")):
                assert 0 <= v["value"] <= 100, (k, v)
