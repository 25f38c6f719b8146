"""The SU(3) force kernel's share (%) of its roofline in drawing steps:
the least time its launches' bytes and operations allow (HBM 3.35 TB/s,
the float32 or float64 peak of the spec's precision) over their device
time in the profiled stretch. A launch reads the lattice once and writes
the force once (18 values a link each) and the per-chain traces; the
force needs 13 complex 3x3 products a link (the kernel makes 22, to give
the plain version's force off the group too). At 8^4 x 8 chains float32
the bytes bound it: 5.63 us."""
import math

from perfbench import flops, trace


def read(ctx):
    spec = ctx["spec"]
    if ctx["kind"] != "draw" or spec["group"] != "SU3":
        return None
    n, seconds = trace.kernel_time(ctx["trace"], "su3_force_fwd")
    if n == 0 or seconds <= 0:
        return None
    precision = spec.get("precision", "float32")
    size = 8 if precision == "float64" else 4
    nchains = ctx["nchains"]
    links = 4 * math.prod(spec["latvolume"]) * nchains
    by_bytes = (2 * 18 * links + nchains) * size / flops.HBM_BYTES_PER_S
    by_ops = (flops.SU3_FORCE * flops.PRODUCT * links
              / flops.PEAK_OPS_PER_S[precision])
    return 100.0 * n * max(by_bytes, by_ops) / seconds
