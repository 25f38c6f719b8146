"""The SU(3) force backward's roofline reader (metrics/
su3_force_bwd_roofline.train.py) on hand-made reduced traces: the
bytes-bound share computed by hand for known launch counts and times, a
call as one launch or as two, and None where it finds nothing to read."""
import pytest

from perfbench import bench

SPEC = {"group": "SU3", "latvolume": [8, 8, 8, 8]}
#: one float32 call at 8^4 x 8: (3 x 18 x 131072 links + 8 chains) x 4
#: bytes at 3.35 TB/s
BOUND_S = (3 * 18 * 131072 + 8) * 4 / 3.35e12


def _trace(by_kernel):
    return {"window_s": 1.0, "busy_s": 0.5, "kernels": 100,
            "by_kernel": by_kernel}


def _ctx(trace, kind="train", spec=SPEC, nchains=8):
    return {"job": "train" if kind == "train" else "eval", "kind": kind,
            "trace": trace, "spec": spec, "nchains": nchains}


def _read(ctx):
    return bench.reader("su3_force_bwd_roofline.train")(ctx)


def test_the_bound_at_8x8_in_float32_and_float64():
    assert abs(BOUND_S - 8.451e-6) < 1e-9
    t = _trace({"void {anonymous}::su3_force_bwd_link_kernel<double>(...)":
                (2, 2 * 40e-6)})
    spec = dict(SPEC, precision="float64")
    assert _read(_ctx(t, spec=spec)) == pytest.approx(
        100 * 2 * 2 * BOUND_S / (2 * 40e-6))
    assert 2 * BOUND_S == pytest.approx(16.902e-6, abs=1e-9)


@pytest.mark.parametrize("launches", [1, 2])
def test_a_call_of_one_or_two_launches(launches):
    """8 calls: the device time is every su3_force_bwd kernel's, the calls
    the launches of one of them; the forward, another kernel and a
    smaller lattice leave it as it is computed by hand."""
    by_kernel = {
        "void {anonymous}::su3_force_bwd_link_kernel<float>(...)":
            (8, 8 * 60e-6),
        "void {anonymous}::su3_force_fwd_kernel<float>(...)": (9, 9 * 39e-6),
        "elementwise": (1000, 1e-2)}
    seconds = 8 * 60e-6
    if launches == 2:
        by_kernel["void {anonymous}::su3_force_bwd_plaq_kernel<float>(...)"] \
            = (8, 8 * 20e-6)
        seconds += 8 * 20e-6
    assert _read(_ctx(_trace(by_kernel))) == pytest.approx(
        100 * 8 * BOUND_S / seconds)
    # 4^4 x 3 chains: the bound scales with the links and the chains
    small = dict(SPEC, latvolume=[4, 4, 4, 4])
    want = 100 * 8 * (3 * 18 * 3072 + 3) * 4 / 3.35e12 / seconds
    assert _read(_ctx(_trace(by_kernel), spec=small, nchains=3)) == \
        pytest.approx(want)


@pytest.mark.parametrize("case", ["draw", "u1", "absent", "forward_only",
                                  "no_time"])
def test_none_where_there_is_nothing_to_read(case):
    t = _trace({"su3_force_bwd_link_kernel<float>": (8, 8e-4)})
    ctx = _ctx(t)
    if case == "draw":
        ctx = _ctx(t, kind="draw")
    elif case == "u1":
        ctx = _ctx(t, spec={"group": "U1", "latvolume": [16, 16]})
    elif case == "absent":
        ctx = _ctx(_trace({"elementwise": (10, 1e-3)}))
    elif case == "forward_only":
        ctx = _ctx(_trace({"su3_force_fwd_kernel<float>": (9, 1e-3)}))
    elif case == "no_time":
        ctx = _ctx(_trace({"su3_force_bwd_link_kernel<float>": (8, 0.0)}))
    assert _read(ctx) is None
