"""The port's SU(3) group numerics (ops/su3.py) and HaarSUN against the
JAX package's, on the same complex128 inputs made from a seed: 1e-12 (a
handful of 3x3 products and one closed-form eigen-solve, each agreeing to
a few ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_torch import distributions as tdist
from l2hmc_torch.ops import su3 as tg
from l2hmc_tpu import distributions as jdist
from l2hmc_tpu.ops import su3 as jg
from torch_parity import momentum_draws, to_torch

torch.set_num_threads(1)

TOL = 1e-12


def _ginibre(shape=(5, 7), seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return scale * (rng.normal(size=(*shape, 3, 3))
                    + 1j * rng.normal(size=(*shape, 3, 3)))


def _close(t, j, tol=TOL):
    if isinstance(t, torch.Tensor):
        t = t.detach().resolve_conj().numpy()
    np.testing.assert_allclose(t, np.asarray(j), atol=tol, rtol=0)


UNARY = ["adjoint", "trace", "det3x3", "norm2", "expm_taylor", "expm",
         "projectTAH", "rsqrtPHM3", "projectU", "projectSU", "su3_to_vec",
         "group_to_vec", "kinetic_energy"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_matches(name):
    z = _ginibre(scale=0.4 if name.startswith("expm") else 1.0)
    if name == "rsqrtPHM3":
        z = np.swapaxes(z.conj(), -1, -2) @ z       # hermitian positive
    _close(getattr(tg, name)(torch.from_numpy(z)),
           getattr(jg, name)(jnp.asarray(z)))


@pytest.mark.parametrize("adj_a,adj_b", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_mul_matches(adj_a, adj_b):
    a, b = _ginibre(seed=1), _ginibre(seed=2)
    _close(tg.mul(torch.from_numpy(a), torch.from_numpy(b), adj_a, adj_b),
           jg.mul(jnp.asarray(a), jnp.asarray(b), adj_a, adj_b))


def test_update_gauge_and_checks_match():
    x = np.asarray(jg.projectSU(jnp.asarray(_ginibre(seed=3))))
    p = np.asarray(jg.projectTAH(jnp.asarray(_ginibre(seed=4, scale=0.3))))
    tx, tp = torch.from_numpy(x), torch.from_numpy(p)
    _close(tg.update_gauge(tx, tp), jg.update_gauge(jnp.asarray(x),
                                                    jnp.asarray(p)))
    rough = x + 1e-3 * _ginibre(seed=5)
    for name in ("checkU", "checkSU"):
        for t, j in zip(getattr(tg, name)(torch.from_numpy(rough)),
                        getattr(jg, name)(jnp.asarray(rough))):
            _close(t, j)
    a, b = tg.checkSU(tg.projectSU(torch.from_numpy(rough)))
    assert float(b.max()) < 1e-13


def test_vec_roundtrip_matches():
    v = np.random.default_rng(6).normal(size=(4, 5, 8))
    _close(tg.vec_to_su3(torch.from_numpy(v)), jg.vec_to_su3(jnp.asarray(v)))
    # projectSU of an algebra element: x†x is far from I and can be
    # ill-conditioned, which amplifies the last-ulp differences: 1e-10
    _close(tg.vec_to_group(torch.from_numpy(v)),
           jg.vec_to_group(jnp.asarray(v)), tol=1e-10)
    _close(tg.su3_to_vec(tg.vec_to_su3(torch.from_numpy(v))), v)


def test_eigs3x3_matches_and_degenerate_is_finite():
    rng = np.random.default_rng(7)
    h = _ginibre(shape=(20,), seed=8)
    h = h + np.swapaxes(h.conj(), -1, -2)
    tr = np.trace(h, axis1=-2, axis2=-1).real
    p2 = np.trace(h @ h, axis1=-2, axis2=-1).real
    det = np.linalg.det(h).real
    for t, j in zip(tg.eigs3x3(*map(torch.from_numpy, (tr, p2, det))),
                    jg.eigs3x3(*map(jnp.asarray, (tr, p2, det)))):
        _close(t, j)
    # exactly degenerate spectrum (the identity): the q floor keeps the
    # values and the gradient finite, and the values equal the reference's
    one = [torch.tensor([3.0], dtype=torch.float64, requires_grad=True),
           torch.tensor([3.0], dtype=torch.float64, requires_grad=True),
           torch.tensor([1.0], dtype=torch.float64, requires_grad=True)]
    es = tg.eigs3x3(*one)
    for t, j in zip(es, jg.eigs3x3(jnp.asarray([3.0]), jnp.asarray([3.0]),
                                   jnp.asarray([1.0]))):
        _close(t.detach(), j)
    sum(e.sum() for e in es).backward()
    assert all(torch.isfinite(a.grad).all() for a in one)
    del rng


def test_random_with_injected_draws_matches():
    shape = (3, 4, 3, 3)
    key = jax.random.PRNGKey(9)
    kr, ki = jax.random.split(key)
    draws = tuple(to_torch(jax.random.normal(k, shape, dtype=jnp.float64))
                  for k in (kr, ki))
    _close(tg.random(shape, draws=draws),
           jg.random(key, shape, dtype=jnp.complex128))
    key = jax.random.PRNGKey(10)
    tv = tg.random_momentum(shape, draws=momentum_draws(key, shape[:-2]))
    _close(tv, jg.random_momentum(key, shape, dtype=jnp.complex128))
    # TAH, and <|p|^2> = 8 per link over a generator's draws
    _close(tg.projectTAH(tv), tv)
    gen = torch.Generator().manual_seed(0)
    p = tg.random_momentum((4000, 3, 3), gen)
    assert abs(float(tg.norm2(p).mean()) - 8.0) < 0.3
    x = tg.random((50, 3, 3), gen, dtype=torch.complex64)
    assert x.dtype == torch.complex64
    # float32 closed form on raw Ginibre draws (some ill-conditioned)
    assert float(tg.checkSU(x[None])[1]) < 1e-3


def test_haar_sun_matches_with_injected_draws():
    shape = (6, 5)
    key = jax.random.PRNGKey(11)
    kr, ki = jax.random.split(key)
    full = (*shape, 3, 3)
    draws = tuple(to_torch(jax.random.normal(k, full, dtype=jnp.float64))
                  for k in (kr, ki))
    th = tdist.HaarSUN(3, torch.complex128)
    jh = jdist.HaarSUN(3, jnp.complex128)
    tx = th.rsample(shape, draws=draws)
    _close(tx, jh.rsample(key, shape))
    _close(th.log_prob(tx), jh.log_prob(jnp.asarray(tx.numpy())))
    assert tdist._log_haar_volume(2) == jdist._log_haar_volume(2)
    q2 = tdist.HaarSUN(2, torch.complex128).rsample(
        (10,), torch.Generator().manual_seed(1))
    det = q2[:, 0, 0] * q2[:, 1, 1] - q2[:, 0, 1] * q2[:, 1, 0]
    _close(det, np.ones(10))


def test_haar_eigenangle_ks():
    """Eigenangle density of Haar SU(3) against scipy's Householder-QR
    oracle (the KS test of tests/test_distributions.py): two samples of
    20000 x 3 angles differ by D < 0.02."""
    from scipy import stats
    n = 20000
    x = tdist.HaarSUN(3, torch.complex128).rsample(
        (n,), torch.Generator().manual_seed(2)).numpy()
    ang = np.angle(np.linalg.eigvals(x)).ravel()
    u = stats.unitary_group.rvs(3, size=n, random_state=3)
    u = u * (np.linalg.det(u) ** (-1.0 / 3.0))[:, None, None]
    ang_ref = np.angle(np.linalg.eigvals(u)).ravel()
    assert stats.ks_2samp(ang, ang_ref).statistic < 0.02
