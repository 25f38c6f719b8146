"""Device operations per train step inside the `backward` span: autograd's
backward as captured, with what it recomputes.
Read from the span operations each captured train graph records
(Trainer.graph_stats `span_ops`), weighted by its replays over all train
replays. None where the graphs carry no span operations."""


def _counted(parts):
    return parts[-1] == "backward"


def _outer(path):
    parts = path.split("/")
    return _counted(parts) and not any(_counted(parts[:k])
                                       for k in range(1, len(parts)))


def read(ctx):
    if ctx["kind"] != "train":
        return None
    graphs = [g for g in ctx["graph_stats"] if g.get("job") == ctx["job"]]
    n = sum(g["replays"] for g in graphs)
    if n == 0 or any("span_ops" not in g for g in graphs):
        return None
    return sum(g["replays"] * sum(v for p, v in g["span_ops"].items()
                                  if _outer(p))
               for g in graphs) / n
