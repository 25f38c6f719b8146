"""The SU(3) link kernels' share (%) of their roofline in drawing steps:
the least time their launches' bytes allow (HBM 3.35 TB/s) over their
device time in the profiled stretch. `su3_expm_fwd` and `su3_reunit_fwd`
each read every link's matrix once and write it once (18 values a link
each way); their products (9 a link for expm at order 8, 8 for reunit)
take less time than those bytes at the float32 or float64 peak, so the
bytes bound a launch: 5.63 us at 8^4 x 8 chains float32."""
import math

from perfbench import flops, trace


def read(ctx):
    spec = ctx["spec"]
    if ctx["kind"] != "draw" or spec["group"] != "SU3":
        return None
    n, seconds = 0, 0.0
    for name in ("su3_expm_fwd", "su3_reunit_fwd"):
        c, s = trace.kernel_time(ctx["trace"], name)
        n, seconds = n + c, seconds + s
    if n == 0 or seconds <= 0:
        return None
    size = 8 if spec.get("precision", "float32") == "float64" else 4
    links = 4 * math.prod(spec["latvolume"]) * ctx["nchains"]
    bound = 2 * 18 * links * size / flops.HBM_BYTES_PER_S
    return 100.0 * n * bound / seconds
