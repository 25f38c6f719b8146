"""Device kernels per train step in the profiled stretch."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["trace"]["kernels"]:
        return None
    return ctx["trace"]["kernels"] / ctx["traced_steps"]
