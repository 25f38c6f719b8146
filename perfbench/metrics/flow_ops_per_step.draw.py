"""Device operations per drawing step of the Wilson flow's graph
(Trainer.graph_stats, job "flow": its `ops`, weighted by its replays over
the job's step replays). None where the flow's graph is not listed or
carries no operation count."""


def read(ctx):
    if ctx["kind"] != "draw":
        return None
    stats = ctx["graph_stats"]
    n = sum(g["replays"] for g in stats if g.get("job") == ctx["job"])
    flows = [g for g in stats if g.get("job") == "flow"]
    if n == 0 or not flows or any("ops" not in g for g in flows):
        return None
    return sum(g["ops"] * g["replays"] for g in flows) / n
