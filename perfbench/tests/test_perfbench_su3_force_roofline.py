"""The SU(3) force kernel's roofline reader (metrics/
su3_force_roofline.draw.py) on hand-made reduced traces: the share
computed by hand for a known launch count and time, and None where it
finds nothing to read."""
import pytest

from perfbench import bench

SPEC = {"group": "SU3", "latvolume": [8, 8, 8, 8]}
#: one float32 launch at 8^4 x 8: (2 x 18 x 131072 links + 8) x 4 bytes
#: at 3.35 TB/s (the bytes bound it: 13 x 216 x 131072 operations take
#: 5.49 us at 67 TFLOP/s)
BOUND_S = (2 * 18 * 131072 + 8) * 4 / 3.35e12


def _trace(by_kernel):
    return {"window_s": 1.0, "busy_s": 0.5, "kernels": 100,
            "by_kernel": by_kernel}


def _ctx(trace, kind="draw", spec=SPEC, nchains=8):
    return {"job": "eval" if kind == "draw" else "train", "kind": kind,
            "trace": trace, "spec": spec, "nchains": nchains}


def _read(ctx):
    return bench.reader("su3_force_roofline.draw")(ctx)


def test_share_of_the_byte_bound():
    assert abs(BOUND_S - 5.634e-6) < 1e-9
    t = _trace({"void {anonymous}::su3_force_fwd_kernel<float>(...)":
                (45, 45 * 20e-6), "elementwise": (10, 1e-3)})
    assert _read(_ctx(t)) == pytest.approx(100 * BOUND_S / 20e-6)


def test_float64_and_an_operation_bound_lattice():
    # float64 at 8^4 x 8: bytes 11.27 us, operations 10.83 us at 34 TFLOP/s
    t = _trace({"su3_force_fwd_kernel<double>": (2, 2 * 40e-6)})
    spec = dict(SPEC, precision="float64")
    assert _read(_ctx(t, spec=spec)) == pytest.approx(
        100 * BOUND_S * 2 / 40e-6)
    ops = 13 * 216 * 131072 / 34e12
    assert ops < 2 * BOUND_S


@pytest.mark.parametrize("case", ["u1", "train", "absent", "no_time"])
def test_none_where_there_is_nothing_to_read(case):
    t = _trace({"su3_force_fwd_kernel<float>": (9, 9e-5)})
    ctx = _ctx(t)
    if case == "u1":
        ctx = _ctx(t, spec={"group": "U1", "latvolume": [16, 16]})
    elif case == "train":
        ctx = _ctx(t, kind="train")
    elif case == "absent":
        ctx = _ctx(_trace({"elementwise": (10, 1e-3)}))
    elif case == "no_time":
        ctx = _ctx(_trace({"su3_force_fwd_kernel<float>": (9, 0.0)}))
    assert _read(ctx) is None
