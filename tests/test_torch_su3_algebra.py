"""The port's su(3) algebra module against the JAX package's, every public
function on the same inputs at complex128 / float64 on the CPU: 1e-12,
1e-10 for the closed-form log (its eigenvalue branches included). The
near-identity random elements take the JAX draws (the uniforms of each
embedded SU(2)) as tensors. The JAX side runs op by op; its inputs share
one batch shape, (4, 3, 3), so its primitives compile once per file."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_torch.ops import su3 as tg
from l2hmc_torch.ops import su3_algebra as talg
from l2hmc_tpu.ops import su3 as jg
from l2hmc_tpu.ops import su3_algebra as jalg
from torch_parity import to_torch

torch.set_num_threads(1)

TOL = 1e-12


def _close(t, j, atol=TOL):
    np.testing.assert_allclose(t.detach().resolve_conj().numpy(),
                               np.asarray(j), atol=atol, rtol=0)


def J(fn, *args):
    return fn(*args)


def JIT(fn, *args):
    """fn(*args) as one compiled program: cheaper than op by op for the
    autodiff-heavy reference functions."""
    return jax.jit(fn)(*args)


B = 4


@pytest.fixture(scope="module")
def fields():
    """Haar links and TAH momenta, (6, 4, 3, 3) each: every input of the
    file is one batch of 4 (or a single matrix) of these."""
    return {"haar": JIT(lambda k: jg.random(k, (6, B, 3, 3),
                                            dtype=jnp.complex128),
                        jax.random.PRNGKey(0)),
            "tah": JIT(lambda k: jg.random_momentum(k, (6, B, 3, 3),
                                                    dtype=jnp.complex128),
                       jax.random.PRNGKey(1))}


def test_constants_equal():
    for name in ("gell_mann", "su3gen", "fabc", "dabc"):
        t, j = getattr(talg, name)(), getattr(jalg, name)()
        assert t.dtype == (torch.complex128 if name in ("gell_mann", "su3gen")
                           else torch.float64), name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def test_adjoint_representations(fields):
    x, y, m = fields["tah"][0], fields["tah"][1], fields["haar"][0]
    v = jax.random.normal(jax.random.PRNGKey(3), (B, 8), dtype=jnp.float64)
    _close(talg.su3fabc(to_torch(v)), J(jalg.su3fabc, v))
    _close(talg.su3dabc(to_torch(v)), J(jalg.su3dabc, v))
    _close(talg.SU3Ad(to_torch(m)), J(jalg.SU3Ad, m))
    _close(talg.su3ad(to_torch(x)), J(jalg.su3ad, x))
    _close(talg.su3adapply(talg.su3ad(to_torch(x)), to_torch(y)),
           J(lambda a, b: jalg.su3adapply(jalg.su3ad(a), b), x, y))
    # adX(Y) is the commutator, on the port alone
    tx, ty = to_torch(x), to_torch(y)
    _close(talg.su3adapply(talg.su3ad(tx), ty), (tx @ ty - ty @ tx).numpy())


def test_derivative_machinery(fields):
    h = fields["haar"]
    m = J(lambda a, b: a @ (2.0 * b), h[1], h[2])
    x, y = h[3], h[4]
    tm, tx, ty = to_torch(m), to_torch(x), to_torch(y)
    _close(talg.diffprojectTAH(tm), J(jalg.diffprojectTAH, m))
    p = J(jg.projectTAH, m)
    _close(talg.diffprojectTAH(tm, to_torch(p)),
           J(jalg.diffprojectTAH, m, p))
    _close(talg.diffprojectTAHCross(tx @ ty, x=tx),
           J(lambda a, b: jalg.diffprojectTAHCross(a @ b, x=a), x, y))
    ad = J(jalg.SU3Ad, x)
    _close(talg.diffprojectTAHCross(tx @ ty, Adx=to_torch(ad)),
           J(lambda a, b, c: jalg.diffprojectTAHCross(a @ b, Adx=c), x, y,
             ad))
    with pytest.raises(ValueError, match="x or Adx"):
        talg.diffprojectTAHCross(tm)
    adx = J(lambda a: jalg.su3ad(0.3 * a), fields["tah"][2])
    for order in (13, 6):
        _close(talg.diffexp(to_torch(adx), order=order),
               J(lambda a: jalg.diffexp(a, order=order), adx))


def test_gradient_and_jacobian(fields):
    x = fields["haar"][5, 0]

    def f_j(u):
        return jnp.real(jg.trace(u @ u)).sum()

    def f_t(u):
        return torch.real(tg.trace(u @ u)).sum()

    jy, jd = JIT(lambda u: jalg.su3_gradient(f_j, u), x)
    ty, td = talg.su3_gradient(f_t, to_torch(x))
    _close(ty, jy)
    _close(td, jd)
    gm = J(lambda a: jg.expm(0.3 * a, s=2), fields["tah"][3, 0])
    tgm = to_torch(gm)
    for is_su3 in (True, False):
        jz, jjac = JIT(lambda u: jalg.su3_jacobian(
            lambda w: gm @ w @ gm, u, is_SU3=is_su3), x)
        tz, tjac = talg.su3_jacobian(lambda u: tgm @ u @ tgm, to_torch(x),
                                     is_SU3=is_su3)
        _close(tz, jz)
        _close(tjac, jjac)
    # a left translation's Jacobian is orthogonal: logdet 0 (the port alone)
    _, jac = talg.su3_jacobian(lambda u: tgm @ u, to_torch(x))
    assert abs(float(torch.linalg.slogdet(jac)[1])) < 1e-9


def _log_input(fields, case):
    """Haar links (simple spectra); near-identity ones (clustered
    eigenvalues, the guarded Newton branch); diagonal matrices with an
    exactly repeated eigenvalue (p'(lam) = 0); non-unitary ones (the other
    root of the discriminant)."""
    h = fields["haar"]
    if case == "haar":
        return h[5]
    if case == "near_identity":
        return J(lambda a: jg.expm(1e-3 * a, s=2), fields["tah"][4])
    if case == "repeated":
        d = jnp.diag(jnp.asarray([1j, 1j, -1.0], jnp.complex128))
        return jnp.broadcast_to(d, (B, 3, 3))
    return h[0] * 1.7 + 0.2


@pytest.mark.parametrize("case", ["haar", "near_identity", "repeated",
                                  "general"])
def test_charpoly_eig_log(fields, case):
    x = _log_input(fields, case)
    tx = to_torch(x)
    for a, b in zip(talg.charpoly3x3(tx), J(jalg.charpoly3x3, x)):
        _close(a, b)
    _close(talg.eig3x3(tx), J(jalg.eig3x3, x), 1e-10)
    _close(talg.log3x3(tx), J(jalg.log3x3, x), 1e-10)


def test_sun_manifold_ops(fields):
    x, y = fields["haar"][1], fields["haar"][2]
    u = J(lambda a, b: a @ (0.1 * b), x, fields["tah"][5])
    tx, ty, tu = to_torch(x), to_torch(y), to_torch(u)
    _close(talg.sun_exp(tx, tu), J(jalg.sun_exp, x, u))
    _close(talg.sun_log(tx, ty), J(jalg.sun_log, x, y), 1e-10)
    _close(talg.sun_proju(tx, tu), J(jalg.sun_proju, x, u))


def _su2_draws(key, batch):
    return jax.random.uniform(key, batch + (3,), dtype=jnp.float64,
                              minval=0.0, maxval=0.5)


@pytest.mark.parametrize("eps", [0.05, 0.2])
def test_near_identity_generators(eps):
    key = jax.random.PRNGKey(18)
    _close(talg.random_SU2(None, eps, (B,),
                           draws=to_torch(_su2_draws(key, (B,)))),
           J(lambda k: jalg.random_SU2(k, eps, (B,)), key))
    draws = [to_torch(_su2_draws(k, (B,))) for k in jax.random.split(key, 3)]
    m3 = talg.random_SU3(None, eps, (B,), draws=draws)
    _close(m3, J(lambda k: jalg.random_SU3(k, eps, (B,)), key))
    arr = talg.random_SU3_array(None, B, eps, draws=draws)
    _close(arr, J(lambda k: jalg.random_SU3_array(k, B, eps), key))
    # from a generator: on the group, near the identity, complex64 too
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.complex128, torch.complex64):
        m = talg.random_SU3(gen, eps, (64,), dtype=dtype)
        assert m.dtype == dtype
        assert float(tg.checkSU(m)[1].max()) < (1e-10 if dtype ==
                                                torch.complex128 else 1e-5)
        dist = (m - torch.eye(3, dtype=dtype)).abs().amax(dim=(1, 2))
        assert float(dist.max()) < 4.0 * eps
