"""Seconds the trainer spent capturing and instantiating its step graphs
(Trainer.graph_stats: capture_s + instantiate_s over every graph)."""


def read(ctx):
    stats = ctx["graph_stats"]
    if not stats:
        return None
    return sum(g["capture_s"] + g["instantiate_s"] for g in stats)
