"""The port's component engine (ops/su3_comp.py) against the JAX
package's on the same fields (2^4, 2 chains, float64): the elementwise
algebra to 1e-12, whole force evaluations and trajectories to 1e-10; and
the engine's own invariants (round trip, reunit, energy conservation)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_torch.ops import lattice_su3 as tl
from l2hmc_torch.ops import su3 as su3g
from l2hmc_torch.ops import su3_comp as tc
from l2hmc_tpu.ops import su3_comp as jc
from torch_parity import (LAT, comp_np, eager, momentum_draws,  # noqa: F401
                          su3_fields, to_torch)

torch.set_num_threads(1)

NB = 2
C128 = torch.complex128


def _close_f(t, j, tol=1e-12):
    for a, b in zip(comp_np(t), comp_np(j)):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def _close(t, j, tol=1e-12):
    np.testing.assert_allclose(t.detach().numpy(),
                               np.asarray(j).reshape(t.shape), atol=tol,
                               rtol=0)


@pytest.fixture
def fields(eager):
    x, v = su3_fields(NB)
    return (jc.from_complex_lattice(x), jc.from_complex_lattice(v),
            tc.from_complex_lattice(to_torch(x)),
            tc.from_complex_lattice(to_torch(v)), x, v)


def test_roundtrip_and_layout(fields):
    jx, _, tx, _, x, _ = fields
    _close_f(tx, jx, 0)
    assert tuple(tx.re.shape) == (3, 3, 4 * 16 * NB) and tx.batch == (128,)
    assert tc.batch_size(tx) == 128
    back = tc.to_complex_lattice(tx, LAT, NB, C128)
    assert torch.equal(back, to_torch(x))


@pytest.mark.parametrize("adj_a,adj_b", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_mm_and_trace_mm_match(fields, adj_a, adj_b):
    jx, jv, tx, tv, x, v = fields
    _close_f(tc.mm(tx, tv, adj_a, adj_b), jc.mm(jx, jv, adj_a, adj_b))
    for t, j in zip(tc.trace_mm(tx, tv, adj_a, adj_b),
                    jc.trace_mm(jx, jv, adj_a, adj_b)):
        _close(t, j)
    # against complex matmul
    a = to_torch(x).conj().transpose(-1, -2) if adj_a else to_torch(x)
    b = to_torch(v).conj().transpose(-1, -2) if adj_b else to_torch(v)
    _close_f(tc.mm(tx, tv, adj_a, adj_b), tc.from_complex_lattice(a @ b))


def test_elementwise_algebra_matches(fields):
    jx, jv, tx, tv, _, _ = fields
    _close_f(tc.adjoint(tx), jc.adjoint(jx))
    _close_f(tc.add(tx, tv), jc.add(jx, jv))
    _close_f(tc.scale(tx, 0.3), jc.scale(jx, 0.3))
    _close_f(tc.eye_like(tx), jc.eye_like(jx))
    _close_f(tc.projectTAH(tx), jc.projectTAH(jx))
    for t, j in zip(tc.trace(tx), jc.trace(jx)):
        _close(t, j)
    for t, j in zip(tc.det3x3(tx), jc.det3x3(jx)):
        _close(t, j)
    _close(tc.norm2(tv), jc.norm2(jv))
    _close(tc.su3_to_vec(tv), np.asarray(jc.su3_to_vec(jv)).reshape(8, -1))
    _close(tc.kinetic_energy(tv, NB), jc.kinetic_energy(jv, NB))


def test_float32_expm_and_hmc_keep_links_on_su3():
    """float32 at the 8^4 beta 5.7 record's step size (0.02), 2^4 x 8
    chains: the drift of tr(U^dag U)/3 - 1 takes no sign. expm of
    momenta: |mean| < 2e-9 over 20 draws (the plain Horner form gave
    -1.5e-8 to -1.7e-8); 30 HMC trajectories of 8 leapfrog steps from the
    cold start, every one kept: |mean| < 3e-7 (plain Horner -3.7e-6, which
    left the HMC warmup's links above the action of their reunitarized
    selves, so the first train step after it accepted every chain)."""
    lat, nb = (2, 2, 2, 2), 8
    shape = (nb, 4, *lat, 3, 3)
    gen = torch.Generator().manual_seed(0)

    def drift(f):
        u = tc.to_complex_lattice(f, lat, nb, torch.complex64)
        u = u.reshape(-1, 3, 3).to(C128)
        return float(((u.conj() * u).real.sum((-1, -2)) / 3 - 1).mean())

    def momenta():
        return tc.from_complex_lattice(su3g.random_momentum(
            shape, gen, torch.complex64))

    assert abs(np.mean([drift(tc.expm(tc.scale(momenta(), 0.02)))
                        for _ in range(20)])) < 2e-9
    x = tc.from_complex_lattice(
        torch.eye(3, dtype=torch.complex64).expand(shape).contiguous())
    for _ in range(30):
        x, _, _ = tc.hmc_trajectory(x, momenta(), 5.2, 0.02, 8, lat, nb)
    assert abs(drift(x)) < 3e-7


@pytest.mark.parametrize("order,s", [(12, 2), (8, 2), (12, 0)])
def test_expm_matches(fields, order, s):
    _, jv, _, tv, _, v = fields
    te = tc.expm(tc.scale(tv, 0.2), order=order, s=s)
    _close_f(te, jc.expm(jc.scale(jv, 0.2), order=order, s=s))
    if order == 12:
        ref = torch.linalg.matrix_exp(0.2 * to_torch(v))
        _close_f(te, tc.from_complex_lattice(ref), 1e-11)


def test_projectSU_rsqrt_and_reunit(fields):
    jx, jv, tx, tv, _, _ = fields
    # a rough input: x + 0.1 v
    jr, tr = jc.add(jx, jc.scale(jv, 0.1)), tc.add(tx, tc.scale(tv, 0.1))
    _close_f(tc.projectSU(tr), jc.projectSU(jr), 1e-11)
    _close_f(tc.rsqrtPHM3(tc.mm(tr, tr, adj_a=True)),
             jc.rsqrtPHM3(jc.mm(jr, jr, adj_a=True)), 1e-11)
    # near unitary: reunit equals projectSU, and the reference's reunit
    jn, tn = jc.add(jx, jc.scale(jv, 1e-3)), tc.add(tx, tc.scale(tv, 1e-3))
    _close_f(tc.reunit(tn), jc.reunit(jn))
    _close_f(tc.reunit(tn), tc.projectSU(tn), 1e-12)
    u = tc.reunit(tn)
    _close_f(tc.mm(u, u, adj_a=True), tc.eye_like(u), 1e-14)
    dre, dim = tc.det3x3(u)
    assert float((dre - 1).abs().max()) < 1e-14
    assert float(dim.abs().max()) < 1e-14
    # a fixed point on unitary links (the Haar links are unitary to 1e-13)
    _close_f(tc.reunit(tx), tx, 1e-12)
    _close_f(tc.reunit(u), u, 1e-14)


def test_reunit_gradient_finite_at_exactly_unitary_input():
    """projectSU's backward divides by zero at x†x = I; reunit's must be
    finite there (and non-zero), in both precisions."""
    for dt in (torch.float32, torch.float64):
        e = tc.eye_like(tc.F3(torch.zeros(3, 3, 64, dtype=dt),
                              torch.zeros(3, 3, 64, dtype=dt)))
        w = torch.randn(3, 3, 64, dtype=dt,
                        generator=torch.Generator().manual_seed(0))
        re = e.re.clone().requires_grad_()
        im = e.im.clone().requires_grad_()
        out = tc.reunit(tc.F3(re, im))
        (out.re * w).sum().backward()
        assert torch.isfinite(re.grad).all() and torch.isfinite(im.grad).all()
        assert float(re.grad.abs().max()) > 0


def test_random_momentum_matches():
    key = jax.random.PRNGKey(3)
    jp = jc.random_momentum(key, (128,), dtype=jnp.float64)
    tp = tc.random_momentum(128, draws=momentum_draws(key, (128,)))
    _close_f(tp, jp)
    _close_f(tc.projectTAH(tp), tp, 1e-15)
    gen = torch.Generator().manual_seed(1)
    p = tc.random_momentum(20000, gen, torch.float64)
    assert abs(float(tc.norm2(p).mean()) - 8.0) < 0.15


def test_rolls_and_dirs_match(fields):
    jx, _, tx, _, _, _ = fields
    n_dir = 16 * NB
    troll, jroll = tc.make_roll(LAT, NB), jc.make_roll(LAT, NB)
    for u in range(4):
        td, jd = tc.dir_slice(tx, u, n_dir), jc.dir_slice(jx, u, n_dir)
        _close_f(td, jd, 0)
        for shift in (-1, 1):
            _close_f(tc.roll_f(td, shift, u, troll),
                     jc.roll_f(jd, shift, u, jroll), 0)
    parts = [tc.dir_slice(tx, u, n_dir) for u in range(4)]
    _close_f(tc.stack_dirs(parts), tx, 0)


def test_traces_and_action_match(fields):
    jx, _, tx, _, x, _ = fields
    for t, j in zip(tc.plaq_traces(tx, LAT, NB), jc.plaq_traces(jx, LAT, NB)):
        _close(t, j)
    tres, _ = tc.plaq_traces(tx, LAT, NB, per_plane=True)
    jres, _ = jc.plaq_traces(jx, LAT, NB, per_plane=True)
    assert len(tres) == 6
    for t, j in zip(tres, jres):
        _close(t, j)
    for t, j in zip(tc.rect_traces(tx, LAT, NB), jc.rect_traces(jx, LAT, NB)):
        _close(t, j)
    for c1 in (0.0, -0.331):
        ta = tc.action(tx, 5.7, LAT, NB, c1=c1)
        _close(ta, jc.action(jx, 5.7, LAT, NB, c1=c1), 1e-11)
        _close(ta, tl.action(to_torch(x), 5.7, LAT, c1=c1).numpy(), 1e-11)


def test_force_and_traces_matches(fields):
    """Against the reference's engine, against the AoS closed form through
    to_complex_lattice, and against the port's own generic staples: valid
    on the group only, so the links are Haar (unitary to ~1e-13)."""
    jx, _, tx, _, x, _ = fields
    tf, ttr = tc.force_and_traces(tx, 2.3, LAT, NB)
    jf, jtr = jc.force_and_traces(jx, 2.3, LAT, NB)
    _close_f(tf, jf, 1e-10)
    _close(ttr, jtr, 1e-10)
    aos = tl.grad_action(to_torch(x), 2.3, LAT)
    _close_f(tf, tc.from_complex_lattice(aos), 1e-10)
    st = tc.staples(tx, LAT, NB)
    _close_f(st, jc.staples(jx, LAT, NB), 1e-10)
    via_staples = tc.scale(tc.projectTAH(tc.mm(tx, st)), 2.3 / 3.0)
    _close_f(tf, via_staples, 1e-10)
    _close_f(tc.grad_action(tx, 2.3, LAT, NB), tf, 0)


def test_c1_force_matches(fields):
    jx, _, tx, _, x, _ = fields
    tf = tc.grad_action(tx, 2.3, LAT, NB, c1=-0.331)
    _close_f(tf, jc.grad_action(jx, 2.3, LAT, NB, c1=-0.331), 1e-10)
    _close_f(tf, tc.from_complex_lattice(
        tl.grad_action(to_torch(x), 2.3, LAT, c1=-0.331)), 1e-10)
    assert not tf.re.requires_grad
    # inside a differentiated trajectory the inner graph is kept
    re = tx.re.clone().requires_grad_()
    f2 = tc.grad_action(tc.F3(re, tx.im), 2.3, LAT, NB, c1=-0.331)
    (g,) = torch.autograd.grad(f2.re[0, 1].sum(), re)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


def test_clover_charge_matches(fields):
    jx, jv, tx, tv, _, _ = fields
    for t, j in zip(tc.clover_field(tx, LAT, NB),
                    jc.clover_field(jx, LAT, NB)):
        _close_f(t, j, 1e-11)
    _close(tc.topo_charge_clover(tx, LAT, NB),
           jc.topo_charge_clover(jx, LAT, NB), 1e-12)
    cold = tc.eye_like(tx)
    assert float(tc.topo_charge_clover(cold, LAT, NB).abs().max()) == 0.0


@pytest.mark.parametrize("c1", [0.0, -0.331])
def test_hmc_trajectory_matches(fields, c1):
    jx, jv, tx, tv, _, _ = fields
    nlf = 3 if c1 == 0.0 else 1     # the reference's c1 force is autodiff
    jo = jc.hmc_trajectory(jx, jv, 2.3, 0.05, nlf, LAT, NB, c1=c1,
                           with_traces=True)
    to = tc.hmc_trajectory(tx, tv, 2.3, 0.05, nlf, LAT, NB, c1=c1,
                           with_traces=True)
    _close_f(to[0], jo[0], 1e-10)
    _close_f(to[1], jo[1], 1e-10)
    _close(to[2], jo[2], 1e-10)
    for t, j in zip(to[3], jo[3]):
        _close(t, j, 1e-10)
    assert len(tc.hmc_trajectory(tx, tv, 2.3, 0.05, 1, LAT, NB, c1=c1)) == 3
    xl, vl, fl = tc.leapfrog(tx, tv, 2.3, 0.05,
                             tc.grad_action(tx, 2.3, LAT, NB, c1=c1), LAT, NB,
                             c1=c1)
    if nlf == 1:
        # one leapfrog step from the initial force IS the reference's
        # one-step trajectory: reuse it (the autodiff force is slow op by op)
        j1 = jo
    else:
        j1 = jc.leapfrog(jx, jv, 2.3, 0.05,
                         jc.grad_action(jx, 2.3, LAT, NB, c1=c1), LAT, NB,
                         c1=c1)
    _close_f(xl, j1[0], 1e-10)
    _close_f(vl, j1[1], 1e-10)


def test_energy_conservation_scales_with_eps_squared(fields):
    """|dH| of a fixed-length trajectory falls as eps^2 (leapfrog is
    second order), and the update keeps the links on the group."""
    _, _, tx, tv, _, _ = fields
    dhs = []
    for eps, nlf in ((0.04, 5), (0.02, 10), (0.01, 20)):
        xp, _, dh = tc.hmc_trajectory(tx, tv, 5.7, eps, nlf, LAT, NB)
        dhs.append(float(dh.abs().mean()))
        u = tc.mm(xp, xp, adj_a=True)
        _close_f(u, tc.eye_like(u), 1e-10)
    assert dhs[2] < 0.05
    assert 3.0 < dhs[0] / dhs[1] < 5.0 and 3.0 < dhs[1] / dhs[2] < 5.0
