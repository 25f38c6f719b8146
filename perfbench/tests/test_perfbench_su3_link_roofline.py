"""The SU(3) link kernels' roofline reader (metrics/
su3_link_roofline.draw.py) on hand-made reduced traces: the bytes-bound
share computed by hand for known launch counts and times, and None where
it finds nothing to read."""
import pytest

from perfbench import bench

SPEC = {"group": "SU3", "latvolume": [8, 8, 8, 8]}
#: one float32 launch at 8^4 x 8: 2 x 18 x 131072 links x 4 bytes at
#: 3.35 TB/s (the operations, 9 x 216 x 131072 at 67 TFLOP/s, take 3.80 us)
BOUND_S = 2 * 18 * 131072 * 4 / 3.35e12


def _trace(by_kernel):
    return {"window_s": 1.0, "busy_s": 0.5, "kernels": 100,
            "by_kernel": by_kernel}


def _ctx(trace, kind="draw", spec=SPEC, nchains=8):
    return {"job": "eval" if kind == "draw" else "train", "kind": kind,
            "trace": trace, "spec": spec, "nchains": nchains}


def _read(ctx):
    return bench.reader("su3_link_roofline.draw")(ctx)


def test_share_of_the_byte_bound_over_both_kernels():
    assert abs(BOUND_S - 5.634e-6) < 1e-9
    t = _trace({
        "void {anonymous}::su3_expm_fwd_kernel<float>(...)": (44, 44 * 10e-6),
        "void {anonymous}::su3_reunit_fwd_kernel<float>(...)":
            (28, 28 * 15e-6),
        "su3_force_fwd_kernel<float>": (45, 45 * 39e-6),
        "elementwise": (10, 1e-3)})
    assert _read(_ctx(t)) == pytest.approx(
        100 * 72 * BOUND_S / (44 * 10e-6 + 28 * 15e-6))


def test_float64_and_one_kernel_alone():
    t = _trace({"su3_reunit_fwd_kernel<double>": (2, 2 * 20e-6)})
    spec = dict(SPEC, precision="float64")
    assert _read(_ctx(t, spec=spec)) == pytest.approx(
        100 * 2 * 2 * BOUND_S / (2 * 20e-6))
    # 4^4 x 3 chains: the bound scales with the links
    t = _trace({"su3_expm_fwd_kernel<float>": (3, 3 * 2e-6)})
    small = dict(SPEC, latvolume=[4, 4, 4, 4])
    assert _read(_ctx(t, spec=small, nchains=3)) == pytest.approx(
        100 * BOUND_S * 3 / 128 / 2e-6)


@pytest.mark.parametrize("case", ["u1", "train", "absent", "force_only",
                                  "no_time"])
def test_none_where_there_is_nothing_to_read(case):
    t = _trace({"su3_expm_fwd_kernel<float>": (9, 9e-5)})
    ctx = _ctx(t)
    if case == "u1":
        ctx = _ctx(t, spec={"group": "U1", "latvolume": [16, 16]})
    elif case == "train":
        ctx = _ctx(t, kind="train")
    elif case == "absent":
        ctx = _ctx(_trace({"elementwise": (10, 1e-3)}))
    elif case == "force_only":
        ctx = _ctx(_trace({"su3_force_fwd_kernel<float>": (45, 1e-3)}))
    elif case == "no_time":
        ctx = _ctx(_trace({"su3_reunit_fwd_kernel<float>": (9, 0.0)}))
    assert _read(ctx) is None
