"""The port's U(1) group and lattice functions against the JAX package, at
float64 on the CPU, to 1e-12 (the same formulas, so only rounding of a few
ops differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_torch.ops import lattice_u1 as tlat
from l2hmc_torch.ops import u1 as tg
from l2hmc_tpu.ops import lattice_u1 as jlat
from l2hmc_tpu.ops import u1 as jg

torch.set_num_threads(1)

NT, NX, NB = 6, 8, 5
BETA = 3.3
TOL = 1e-12


def _x(seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (NB, 2 * NT * NX))


def _close(t, j, atol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", ["wilson_loops", "wilson_loops4x4"])
def test_loops(name):
    x = _x()
    _close(getattr(tlat, name)(torch.from_numpy(x), NT, NX),
           getattr(jlat, name)(jnp.asarray(x), NT, NX))


def test_action_and_closed_form_force():
    x = _x(1)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(tlat.action(tx, BETA, NT, NX), jlat.action(jx, BETA, NT, NX),
           atol=1e-11)
    _close(tlat.grad_action(tx, BETA, NT, NX),
           jlat.grad_action(jx, BETA, NT, NX))


def test_plaq_adjoint():
    y = np.random.default_rng(2).normal(size=(NB, NT, NX))
    shape = (NB, 2 * NT * NX)
    _close(tlat.plaq_adjoint(torch.from_numpy(y), shape),
           jlat.plaq_adjoint(jnp.asarray(y), shape))


def test_grad_action_equals_autograd_through_action():
    tx = torch.from_numpy(_x(3)).requires_grad_(True)
    s = tlat.action(tx, BETA, NT, NX).sum()
    (g,) = torch.autograd.grad(s, tx)
    np.testing.assert_allclose(
        tlat.grad_action(tx.detach(), BETA, NT, NX).numpy(), g.numpy(),
        atol=TOL)


def test_lattice_grad_action_cpu_takes_plain_force():
    """LatticeU1.grad_action on a CPU tensor: the force kernel's plain
    version, equal to the closed form."""
    tx = torch.from_numpy(_x(4))
    lat = tlat.LatticeU1(NB, (NT, NX))
    _close(lat.grad_action(tx, BETA), jlat.grad_action(jnp.asarray(tx.numpy()),
                                                       BETA, NT, NX))


def test_charges_and_metrics():
    x = _x(5, scale=6.0)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    tw, jw = tlat.wilson_loops(tx, NT, NX), jlat.wilson_loops(jx, NT, NX)
    _close(tlat.sin_charges(tw), jlat.sin_charges(jw))
    _close(tlat.int_charges(tw), jlat.int_charges(jw))
    _close(tlat.project_angle(tw), jlat.project_angle(jw))
    tm, jm = tlat.calc_metrics(tx, NT, NX), jlat.calc_metrics(jx, NT, NX)
    assert tm.keys() == jm.keys()
    for k in tm:
        _close(tm[k], jm[k])
    lat = tlat.LatticeU1(NB, (NT, NX))
    jl = jlat.LatticeU1(NB, (NT, NX))
    _close(lat.charges(tx).sinQ, jl.charges(jx).sinQ)
    _close(lat.plaqs4x4(tx), jl.plaqs4x4(jx))


@pytest.mark.parametrize("beta", [0.5, 4.0, 6.0, 12.0])
def test_plaq_exact(beta):
    """float32 in both packages (torch.special vs jax.scipy.special):
    held to 2 float32 ulps at values < 1."""
    t = float(tlat.plaq_exact(beta))
    j = float(jlat.plaq_exact(beta))
    assert abs(t - j) <= 2.4e-7
    x = _x(6)
    np.testing.assert_allclose(
        tlat.plaqs_diff(torch.from_numpy(x), beta, NT, NX).numpy(),
        np.asarray(jlat.plaqs_diff(jnp.asarray(x), beta, NT, NX)), atol=2.4e-7)


def test_group_ops():
    x = _x(7, scale=20.0)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(tg.compat_proj(tx), jg.compat_proj(jx))
    _close(tg.kinetic_energy(tx), jg.kinetic_energy(jx), atol=1e-10)
    _close(tg.vec_to_group(tg.group_to_vec(tx)),
           jg.vec_to_group(jg.group_to_vec(jx)))
    assert torch.allclose(torch.angle(tg.exp(tx)),
                          torch.from_numpy(np.angle(np.asarray(jg.exp(jx)))),
                          atol=TOL)
