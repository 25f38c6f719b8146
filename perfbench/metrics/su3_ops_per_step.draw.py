"""Device operations per drawing step inside the `su3.*` spans of
ops/su3_comp.py (force_and_traces, expm, reunit) under the `transition`
and `flow` spans, as captured.
Read from the span operations each captured graph of the job and the
flow's graph record (Trainer.graph_stats `span_ops`), weighted by their
replays over the job's step replays. None where the graphs carry no span
operations."""


def _counted(parts):
    return (parts[0] in ("transition", "flow")
            and parts[-1].startswith("su3."))


def _outer(path):
    parts = path.split("/")
    return _counted(parts) and not any(_counted(parts[:k])
                                       for k in range(1, len(parts)))


def read(ctx):
    if ctx["kind"] != "draw":
        return None
    stats = ctx["graph_stats"]
    steps = [g for g in stats if g.get("job") == ctx["job"]]
    graphs = steps + [g for g in stats if g.get("job") == "flow"]
    n = sum(g["replays"] for g in steps)
    if n == 0 or any("span_ops" not in g for g in graphs):
        return None
    return sum(g["replays"] * sum(v for p, v in g["span_ops"].items()
                                  if _outer(p))
               for g in graphs) / n
