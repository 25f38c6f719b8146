"""The port's 4D SU(3) lattice functions (ops/lattice_su3.py) against the
JAX package's on the same Haar links (2^4, 2 chains, complex128): 1e-11
(sums of a few hundred 3x3 products, each agreeing to a few ulp), and the
analytic force against the port's own autograd route."""
import numpy as np
import pytest
import torch

from l2hmc_torch.ops import lattice_su3 as tl
from l2hmc_tpu.ops import lattice_su3 as jl
from torch_parity import LAT, eager, su3_fields, to_torch  # noqa: F401

torch.set_num_threads(1)

TOL = 1e-11
VOL = int(np.prod(LAT))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().resolve_conj().numpy(),
                               np.asarray(j), atol=tol, rtol=0)


@pytest.fixture
def fields(eager):
    x, v = su3_fields()
    return x, v, to_torch(x), to_torch(v)


def test_wilson_loops_match(fields):
    x, _, tx, _ = fields
    tp, trs = tl.wilson_loops(tx, LAT, needs_rect=True)
    jp, jrs = jl.wilson_loops(x, LAT, needs_rect=True)
    assert tuple(tp.shape) == (6, 2, *LAT)
    assert tuple(trs.shape) == (12, 2, *LAT)
    _close(tp, jp)
    _close(trs, jrs)
    assert tl.wilson_loops(tx, LAT)[1] is None


@pytest.mark.parametrize("c1", [0.0, -0.331])
def test_action_and_coeffs_match(fields, c1):
    x, _, tx, _ = fields
    _close(tl.action(tx, 5.7, LAT, c1=c1), jl.action(x, 5.7, LAT, c1=c1))
    tc, jc = tl.coeffs(5.7, c1), jl.coeffs(5.7, c1)
    assert tc.keys() == jc.keys()
    for k in tc:
        assert abs(tc[k] - float(jc[k])) < 1e-15


def test_staples_match(fields):
    x, _, tx, _ = fields
    _close(tl.staples(tx, LAT), jl.staples(x, LAT))


@pytest.mark.parametrize("c1", [0.0, -0.331])
def test_grad_action_matches_reference_and_autograd(fields, c1):
    x, _, tx, _ = fields
    tf = tl.grad_action(tx, 2.3, LAT, c1=c1)
    _close(tf, jl.grad_action(x, 2.3, LAT, c1=c1))
    _close(tl.grad_action_autodiff(tx, 2.3, LAT, c1=c1), tf.detach().numpy())
    _close(tl.grad_action_autodiff(tx, 2.3, LAT, c1=c1),
           jl.grad_action_autodiff(x, 2.3, LAT, c1=c1))
    # the force lives in the algebra
    from l2hmc_torch.ops import su3 as tg
    _close(tg.projectTAH(tf), tf.detach().numpy(), tol=1e-13)


def test_observables_match(fields):
    x, _, tx, _ = fields
    twl, _ = tl.wilson_loops(tx, LAT)
    jwl, _ = jl.wilson_loops(x, LAT)
    _close(tl.plaqs(twl, VOL), jl.plaqs(jwl, VOL))
    _close(tl.sin_charges(twl, VOL), jl.sin_charges(jwl, VOL))
    _close(tl.int_charges(twl), jl.int_charges(jwl))
    tq, jq = tl.charges(twl, VOL), jl.charges(jwl, VOL)
    _close(tq.intQ, jq.intQ)
    _close(tq.sinQ, jq.sinQ)


def test_lattice_class_matches(fields):
    x, v, tx, tv = fields
    tlat, jlat = tl.LatticeSU3(2, LAT), jl.LatticeSU3(2, LAT)
    assert tlat.xshape == jlat.xshape and tlat.xdim == jlat.xdim
    assert tlat.volume == jlat.volume
    _close(tlat.action(tx, 5.7), jlat.action(x, 5.7))
    _close(tlat.grad_action(tx, 5.7), jlat.grad_action(x, 5.7))
    _close(tlat.kinetic_energy(tv), jlat.kinetic_energy(v))
    tm, jm = tlat.calc_metrics(tx), jlat.calc_metrics(x)
    assert tm.keys() == jm.keys()
    for k in tm:
        _close(tm[k], jm[k])
    _close(tlat.plaqs(tx), jlat.plaqs(x))
    _close(tlat.sin_charges(tx), jlat.sin_charges(x))
    _close(tlat.int_charges(tx), jlat.int_charges(x))
    gen = torch.Generator().manual_seed(0)
    assert tuple(tlat.random(gen).shape) == (2, *tlat.xshape)
    assert tuple(tlat.random_momentum(gen).shape) == (2, *tlat.xshape)
    # cold lattice: plaquette 1, action -beta * 6V, zero force
    eye = torch.eye(3, dtype=torch.complex128).expand(2, *tlat.xshape).clone()
    _close(tlat.plaqs(eye), np.ones(2))
    _close(tlat.action(eye, 2.0), -2.0 * 6 * VOL * np.ones(2))
    assert float(tlat.grad_action(eye, 2.0).abs().max()) < 1e-14
    with pytest.raises(ValueError):
        tl.LatticeSU3(2, (4, 4))
