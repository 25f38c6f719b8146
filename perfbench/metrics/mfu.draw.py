"""The whole draw step's share (%) of the card's float32 peak: the
operations the step needs (perfbench/flops.py) over the profiled
stretch's mean step time."""
from perfbench import flops


def read(ctx):
    red = ctx["trace"]
    if ctx["kind"] != "draw" or red["window_s"] <= 0:
        return None
    step_s = red["window_s"] / ctx["traced_steps"]
    return 100.0 * ctx["step_ops"] / (step_s
                                      * flops.PEAK_OPS_PER_S["float32"])
