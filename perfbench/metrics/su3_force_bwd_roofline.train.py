"""The SU(3) force backward's share (%) of its roofline in training
steps: the least time its calls' bytes allow (HBM 3.35 TB/s) over the
device time of its kernels in the profiled stretch. A call (every kernel
named `su3_force_bwd*` once: the plaquette pass and the link pass) reads
the links, the force's cotangent and the per-chain traces' cotangents
once and writes the links' gradient once: 3 x 18 values a link and nb,
8.45 us at 8^4 x 8 chains float32 and 16.9 us in float64. Bytes alone: the
products a backward needs depend on how it is formulated, and no call can
move fewer bytes, so the share cannot pass 100 %."""
import math

from perfbench import flops

FRAGMENT = "su3_force_bwd"


def read(ctx):
    spec = ctx["spec"]
    if ctx["kind"] != "train" or spec["group"] != "SU3":
        return None
    counts, seconds = [], 0.0
    for name, (c, s) in ctx["trace"]["by_kernel"].items():
        if FRAGMENT in name:
            counts.append(c)
            seconds += s
    # each kernel of the backward runs once a call
    calls = max(counts, default=0)
    if calls == 0 or seconds <= 0:
        return None
    size = 8 if spec.get("precision", "float32") == "float64" else 4
    nchains = ctx["nchains"]
    links = 4 * math.prod(spec["latvolume"]) * nchains
    bound = (3 * 18 * links + nchains) * size / flops.HBM_BYTES_PER_S
    return 100.0 * calls * bound / seconds
