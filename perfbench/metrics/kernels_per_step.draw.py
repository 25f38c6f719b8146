"""Device kernels per draw step in the profiled stretch."""


def read(ctx):
    if ctx["kind"] != "draw" or not ctx["trace"]["kernels"]:
        return None
    return ctx["trace"]["kernels"] / ctx["traced_steps"]
