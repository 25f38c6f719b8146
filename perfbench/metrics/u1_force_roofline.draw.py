"""The U(1) forward force kernel's share (%) of its roofline in drawing
steps: the least time its launches' bytes and operations allow (HBM
3.35 TB/s, float32 67 TFLOP/s; at these shapes the bytes bound it) over
their device time in the profiled stretch."""
from perfbench import flops, trace


def read(ctx):
    if ctx["kind"] != "draw" or ctx["spec"]["group"] != "U1":
        return None
    n, seconds = trace.kernel_time(ctx["trace"], "u1_force_fwd")
    if n == 0 or seconds <= 0:
        return None
    nt, nx = ctx["spec"]["latvolume"]
    bound, _ = flops.u1_force_bound_s(ctx["nchains"], nt, nx)
    return 100.0 * n * bound / seconds
