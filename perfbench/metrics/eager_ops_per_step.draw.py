"""Device operations per drawing step that no replayed graph holds: the
kernels, copies and fills a step in the profiled stretch, less the
operations of the job's step graphs and the flow's graph a step (each
graph's `ops` in Trainer.graph_stats, weighted by its replays over the
job's step replays). What is left is launched eagerly: the draws, the
copies into the graph's inputs, the clones of its outputs. None where the
graphs carry no operation counts."""


def read(ctx):
    red = ctx["trace"]
    if ctx["kind"] != "draw" or not red["kernels"]:
        return None
    steps = [g for g in ctx["graph_stats"] if g.get("job") == ctx["job"]]
    flows = [g for g in ctx["graph_stats"] if g.get("job") == "flow"]
    n = sum(g["replays"] for g in steps)
    if n == 0 or any("ops" not in g for g in steps + flows):
        return None
    traced = sum(c for c, _ in red["by_kernel"].values())
    replayed = sum(g["ops"] * g["replays"] for g in steps + flows) / n
    return traced / ctx["traced_steps"] - replayed
