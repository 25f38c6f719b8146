"""Share (%) of the profiled stretch of draw steps in which no kernel,
copy or fill ran on the device."""
from perfbench import trace


def read(ctx):
    if ctx["kind"] != "draw":
        return None
    share = trace.idle_share(ctx["trace"])
    return None if share is None else 100.0 * share
