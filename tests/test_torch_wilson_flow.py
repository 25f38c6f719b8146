"""The port's Wilson flow (ops/wilson_flow.py) against the JAX package's
on the same Haar links (2^4, 2 chains, float64), 1e-10 per step (three
force evaluations, three order-8 exponentials and a reunit, each agreeing
to ~1e-14), plus the flow's own invariants."""
import numpy as np
import pytest
import torch

from l2hmc_torch.ops import su3_comp as tc
from l2hmc_torch.ops import wilson_flow as tw
from l2hmc_tpu.ops import su3_comp as jc
from l2hmc_tpu.ops import wilson_flow as jw
from torch_parity import (LAT, comp_np, eager, su3_fields,  # noqa: F401
                          to_torch)

torch.set_num_threads(1)

NB = 2
TOL = 1e-10


def _close_f(t, j, tol=TOL):
    for a, b in zip(comp_np(t), comp_np(j)):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


@pytest.fixture
def fields(eager):
    x, _ = su3_fields(NB, seed=4)
    return x, jc.from_complex_lattice(x), to_torch(x)


def test_flow_step_matches(fields):
    _, jx, tx = fields
    tf = tc.from_complex_lattice(tx)
    t1, ttr = tw.flow_step(tf, 0.1, LAT, NB)
    j1, jtr = jw.flow_step(jx, 0.1, LAT, NB)
    _close_f(t1, j1)
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), atol=TOL)
    tz, _ = tw._z_and_traces(tf, LAT, NB, tc.make_roll(LAT, NB))
    jz, _ = jw._z_and_traces(jx, LAT, NB, jc.make_roll(LAT, NB))
    _close_f(tz, jz)


def test_flow_and_observables_match(fields):
    x, jx, tx = fields
    tres = tw.flow(tc.from_complex_lattice(tx), 0.1, 2, LAT, NB)
    jres = jw.flow(jx, 0.1, 2, LAT, NB)
    _close_f(tres.x, jres.x)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-15)
    np.testing.assert_allclose(tres.tr.numpy(), np.asarray(jres.tr), atol=TOL)
    tout, tobs = tw.flow_complex_lattice(tx, 0.1, 2)
    jout, jobs = jw.flow_complex_lattice(x, 0.1, 2)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL)
    assert tobs.keys() == jobs.keys()
    for k in tobs:
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]),
                                   atol=TOL)
    np.testing.assert_allclose(
        tw.energy_density(tres.tr, 16).numpy(),
        np.asarray(jw.energy_density(jres.tr, 16)), atol=TOL)


def test_cold_lattice_is_a_fixed_point_with_zero_charge():
    eye = torch.eye(3, dtype=torch.complex128).expand(NB, 4, *LAT, 3, 3)
    cold = tc.from_complex_lattice(eye.clone())
    res = tw.flow(cold, 0.1, 2, LAT, NB)
    _close_f(res.x, cold, 1e-14)
    assert float(tc.topo_charge_clover(res.x, LAT, NB).abs().max()) == 0.0
    obs = tw.flow_observables(res.t, res.tr, 16)
    np.testing.assert_allclose(obs["plaq"].numpy(), 1.0, atol=1e-14)
    np.testing.assert_allclose(obs["t2E"].numpy(), 0.0, atol=1e-12)


def test_flow_smooths_monotonically_and_stays_on_group(fields):
    _, _, tx = fields
    res = tw.flow(tc.from_complex_lattice(tx), 0.05, 6, LAT, NB)
    assert (res.tr[1:] > res.tr[:-1]).all()     # dS_w/dt = -|F|^2 <= 0
    u = tc.mm(res.x, res.x, adj_a=True)
    _close_f(u, tc.eye_like(u), 1e-13)


def test_flow_gradient_with_and_without_checkpoint(fields):
    """The per-step checkpoint changes memory, not numbers: the gradient
    of a flowed charge equals the one taken through plain steps."""
    _, _, tx = fields
    f = tc.from_complex_lattice(tx)

    def grad(fn):
        re = f.re.clone().requires_grad_()
        im = f.im.clone().requires_grad_()
        q = fn(tc.F3(re, im))
        return torch.autograd.grad(q.sum(), (re, im))

    def plain(y):
        for _ in range(2):
            y, _ = tw.flow_step(y, 0.1, LAT, NB)
        return tc.topo_charge_clover(y, LAT, NB)

    g0 = grad(plain)
    g1 = grad(lambda y: tc.topo_charge_clover(
        tw.flow(y, 0.1, 2, LAT, NB).x, LAT, NB))
    for a, b in zip(g0, g1):
        assert torch.isfinite(a).all() and float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, atol=1e-14, rtol=0)
