"""Median host microseconds of a drawing step in the profiled stretch:
the `trainer.step` spans of the cell's job, as l2hmc_torch.utils.spans
aggregates them while the profiler records (a step's draws, the graph's
inputs, replay and outputs, the flow's replay and the loop's host logic,
the harness's own draws included). None where the program has no spans."""


def read(ctx):
    if ctx["kind"] != "draw" or ctx["trace"]["window_s"] <= 0:
        return None
    try:
        from l2hmc_torch.utils import spans
    except ImportError:
        return None
    step = spans.summary()["spans"].get(ctx["job"], {}).get(spans.STEP)
    if not step or step["median_ns"] is None:
        return None
    return step["median_ns"] / 1e3
