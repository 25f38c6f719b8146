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


# ----------------------------------------------------------------------
# Which calls go to the CUDA kernel (ops/kernels/su3_force.py)
# ----------------------------------------------------------------------
def _links(nb=NB, lat=LAT, seed=3):
    g = torch.Generator().manual_seed(seed)
    n = 4 * int(np.prod(lat)) * nb
    return tc.F3(torch.randn((3, 3, n), generator=g, dtype=torch.float64),
                 torch.randn((3, 3, n), generator=g, dtype=torch.float64))


@pytest.fixture
def kernel_calls(monkeypatch):
    """The kernel's entry replaced by a recorder that returns the plain
    version's result; the list of its calls' (beta, lat, nb)."""
    from l2hmc_torch.ops.kernels import su3_force
    calls = []

    def fake(re, im, beta, lat, nb):
        calls.append((beta, tuple(lat), nb, su3_force.pitch(re, im)))
        f, tr = tc.force_and_traces_plain(tc.F3(re, im), beta, lat, nb)
        return f.re, f.im, tr

    monkeypatch.setattr(su3_force, "force_and_traces", fake)
    return calls


def _halo_roll():
    from l2hmc_torch.parallel.halo import make_sharded_comp_roll
    return make_sharded_comp_roll(None, LAT, NB)


@pytest.fixture
def bwd_calls(monkeypatch):
    """The backward kernel's entry replaced by a recorder that returns the
    plain version's autograd VJP; the list of its calls' (force cotangent
    given, trace cotangent given, beta)."""
    from l2hmc_torch.ops.kernels import su3_force
    calls = []

    def fake(re, im, g_re, g_im, g_tr, beta, lat, nb):
        calls.append((g_re is not None, g_tr is not None, beta))
        with torch.enable_grad():
            xr = re.detach().requires_grad_()
            xi = im.detach().requires_grad_()
            f, tr = tc.force_and_traces_plain(tc.F3(xr, xi), beta, lat, nb)
            pairs = [(o, g) for o, g in ((f.re, g_re), (f.im, g_im),
                                         (tr, g_tr)) if g is not None]
            return torch.autograd.grad([o for o, _ in pairs], (xr, xi),
                                       [g for _, g in pairs])

    monkeypatch.setattr(su3_force, "force_and_traces_bwd", fake)
    return calls


@pytest.mark.parametrize("case", ["cpu", "beta_wants_grad", "halo_roll",
                                  "unmarked_roll", "cpu_x_wants_grad",
                                  "x_and_beta_want_grad",
                                  "halo_roll_x_wants_grad",
                                  "unmarked_roll_x_wants_grad",
                                  "cpu_beta_wants_grad"])
def test_force_and_traces_keeps_the_plain_version(monkeypatch, kernel_calls,
                                                  bwd_calls, case):
    """On the CPU, or with a roll that is not the engine's own periodic
    one, the kernels are not taken and the plain version runs unchanged,
    whether or not the links or beta want a gradient (where they do, it
    reaches them). On the card a beta that wants a gradient raises: the
    kernels take beta as a non-trainable scalar, and no caller
    differentiates by it."""
    x, beta, roll = _links(), 2.3, None
    if not case.startswith("cpu"):
        monkeypatch.setattr(tc, "_on_card", lambda t: True)
    x_grad = case.endswith("x_wants_grad") or case == "x_and_beta_want_grad"
    if x_grad:
        x = tc.F3(x.re.requires_grad_(), x.im)
    beta_grad = case.endswith("beta_wants_grad") \
        or case == "x_and_beta_want_grad"
    if beta_grad:
        beta = torch.tensor(2.3, dtype=torch.float64, requires_grad=True)
    elif case.startswith("halo_roll"):
        roll = _halo_roll()
    elif case.startswith("unmarked_roll"):
        own = tc.make_roll(LAT, NB)

        def roll(a, shift, axis):
            return own(a, shift, axis)
    plain_calls = []
    plain = tc.force_and_traces_plain

    def recording_plain(*args, **kw):
        plain_calls.append(args[4] if len(args) > 4 else kw.get("roll"))
        if case.startswith("halo_roll"):   # no mesh here: never roll with it
            return None
        return plain(*args, **kw)

    monkeypatch.setattr(tc, "force_and_traces_plain", recording_plain)
    # a mark of another lattice is not the engine's roll of this one
    assert not tc._kernel_takes(x, LAT, NB, tc.make_roll(LAT, NB + 1))
    if beta_grad and not case.startswith("cpu"):
        with pytest.raises(ValueError, match="non-trainable"):
            tc.force_and_traces(x, beta, LAT, NB, roll)
        assert kernel_calls == [] and plain_calls == []
        return
    out = tc.force_and_traces(x, beta, LAT, NB, roll)
    assert kernel_calls == [] and plain_calls == [roll]
    if case.startswith("cpu"):
        want = plain(x, beta, LAT, NB)
        _close_f(out[0], want[0], 0)
        _close(out[1], want[1].detach().numpy(), 0)
    if beta_grad:
        out[0].re.sum().backward()
        assert beta.grad is not None
    if x_grad and out is not None:
        assert out[0].re.requires_grad
        out[0].re.sum().backward()
        assert x.re.grad is not None and bwd_calls == []


@pytest.mark.parametrize("case", ["no_grad", "grad_but_no_input_wants_it",
                                  "own_roll", "beta_device_scalar",
                                  "complex_views", "transposed_views",
                                  "x_wants_grad"])
def test_force_and_traces_takes_the_kernel_on_the_card(link_kernels,
                                                       kernel_calls, case):
    """With the device check faked: under no_grad (or where no input wants
    a gradient, as at a transition's first force) with roll None or the
    engine's own roll, one kernel call gives the pair; where the links
    want a gradient, the autograd.Function's forward is that one call.
    Views of one complex lattice reach it as they are (pitch 2); a layout
    it does not read is made contiguous first. (HMC's link update takes
    the faked expm kernel.)"""
    link_kernels.card()
    x, beta, roll, pitch = _links(), 2.3, None, 1
    if case == "own_roll":
        roll = tc.make_roll(list(LAT), NB)
    elif case == "beta_device_scalar":
        beta = torch.tensor(2.3, dtype=torch.float64)
    elif case == "complex_views":
        c = torch.complex(x.re, x.im)
        x, pitch = tc.F3(c.real, c.imag), 2
    elif case == "transposed_views":
        x = tc.F3(x.re.transpose(0, 1).contiguous().transpose(0, 1),
                  x.im.transpose(0, 1).contiguous().transpose(0, 1))
    elif case == "x_wants_grad":
        x = tc.F3(x.re.requires_grad_(), x.im)
    if case in ("grad_but_no_input_wants_it", "x_wants_grad"):
        f, tr = tc.force_and_traces(x, beta, LAT, NB, roll)
    else:
        with torch.no_grad():
            f, tr = tc.force_and_traces(x, beta, LAT, NB, roll)
    assert kernel_calls == [(beta, LAT, NB, pitch)]
    assert f.re.requires_grad == (case == "x_wants_grad")
    want = tc.force_and_traces_plain(x, beta, LAT, NB)
    _close_f(f, want[0], 0)
    _close(tr, want[1].detach().numpy(), 0)
    # the flow and HMC reach it through their own roll
    with torch.no_grad():
        tc.hmc_trajectory(x, tc.F3(0.1 * x.re, 0.1 * x.im), 2.3, 0.01, 1,
                          LAT, NB)
    assert len(kernel_calls) == 3
    assert link_kernels.names() == ["expm"]



@pytest.mark.parametrize("case", ["force", "trace", "both", "force_re"])
def test_force_and_traces_gradient_on_the_card_is_the_plain_one(
        monkeypatch, kernel_calls, bwd_calls, case):
    """With the device check faked, links that want a gradient take the
    autograd.Function: one forward kernel call, one backward call with the
    cotangents that were used (None for an output left unused; the other
    half of the force zeros where one half alone was used), and gradients
    bit for bit those of the plain version, on links off the group."""
    x = _links()
    g = torch.Generator().manual_seed(7)
    g_re, g_im = (torch.randn(x.re.shape, generator=g, dtype=torch.float64)
                  for _ in range(2))
    g_tr = torch.randn((NB,), generator=g, dtype=torch.float64)

    def grads(fn):
        xr = x.re.clone().requires_grad_()
        xi = x.im.clone().requires_grad_()
        f, tr = fn(tc.F3(xr, xi), 2.3, LAT, NB)
        loss = 0.0
        if case != "trace":
            loss = loss + (f.re * g_re).sum()
        if case in ("force", "both"):
            loss = loss + (f.im * g_im).sum()
        if case in ("trace", "both"):
            loss = loss + (tr * g_tr).sum()
        loss.backward()
        return xr.grad, xi.grad

    want = grads(tc.force_and_traces_plain)
    monkeypatch.setattr(tc, "_on_card", lambda t: True)
    got = grads(tc.force_and_traces)
    assert len(kernel_calls) == 1
    assert bwd_calls == [(case != "trace", case in ("trace", "both"), 2.3)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_force_and_traces_kernel_gradient_cannot_be_differentiated(
        monkeypatch, kernel_calls, bwd_calls):
    """The backward is once-differentiable: a second derivative through
    the Function raises (no caller takes one; the c1 != 0 force
    differentiates `action`)."""
    monkeypatch.setattr(tc, "_on_card", lambda t: True)
    x = _links()
    x = tc.F3(x.re.requires_grad_(), x.im.requires_grad_())
    f, _ = tc.force_and_traces(x, 2.3, LAT, NB)
    (g,) = torch.autograd.grad((f.re * f.re).sum(), (x.re,),
                               create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()
    assert len(bwd_calls) == 1

class _LinkKernels:
    """su3_link's two entries replaced by recorders that return the plain
    body's result (run with the device check off); `calls` lists each
    call's (name, extra arguments, strides of re); `card()` fakes the
    device check."""

    def __init__(self, monkeypatch):
        from l2hmc_torch.ops.kernels import su3_link
        self.calls = []
        self._monkeypatch = monkeypatch
        self._plain = False
        for name, fn in (("expm", tc.expm), ("reunit", tc.reunit)):
            monkeypatch.setattr(su3_link, name, self._recorder(name, fn))

    def _recorder(self, name, fn):
        def kernel(re, im, *args):
            self.calls.append((name, args, re.stride()))
            self._plain = True
            try:
                out = fn(tc.F3(re, im), *args)
            finally:
                self._plain = False
            return out.re.contiguous(), out.im.contiguous()
        return kernel

    def card(self):
        self._monkeypatch.setattr(tc, "_on_card",
                                  lambda t: not self._plain)

    def names(self):
        return [c[0] for c in self.calls]


@pytest.fixture
def link_kernels(monkeypatch):
    return _LinkKernels(monkeypatch)


def _link_input(fn):
    """Momenta-sized entries for expm, near-unitary-sized for reunit (the
    maps are polynomials: any finite input is in their domain)."""
    x = _links()
    return tc.scale(x, 0.1) if fn == "expm" else x


def _link_call(fn, x):
    if fn == "expm":
        return tc.expm(x, order=8, s=2)
    return tc.reunit(x)


@pytest.mark.parametrize("fn", ["expm", "reunit"])
@pytest.mark.parametrize("case", ["cpu", "cpu_no_grad", "re_wants_grad",
                                  "im_wants_grad"])
def test_link_maps_keep_the_plain_body(link_kernels, fn, case):
    """On the CPU, and on the card where an input wants a gradient, expm
    and reunit run their plain bodies: no kernel call, the same result,
    and the gradient reaches the input."""
    x = _link_input(fn)
    want = _link_call(fn, x)
    if case != "cpu" and case != "cpu_no_grad":
        link_kernels.card()
        x = tc.F3(x.re.clone().requires_grad_(case == "re_wants_grad"),
                  x.im.clone().requires_grad_(case == "im_wants_grad"))
    if case == "cpu_no_grad":
        with torch.no_grad():
            out = _link_call(fn, x)
    else:
        out = _link_call(fn, x)
    assert link_kernels.calls == []
    assert torch.equal(out.re, want.re) and torch.equal(out.im, want.im)
    if case.endswith("wants_grad"):
        (out.re.sum() + out.im.sum()).backward()
        wanted = x.re if case == "re_wants_grad" else x.im
        assert wanted.grad is not None and bool(wanted.grad.abs().sum() > 0)


@pytest.mark.parametrize("fn", ["expm", "reunit"])
@pytest.mark.parametrize("case", ["no_grad", "grad_but_no_input_wants_it",
                                  "no_grad_over_an_input_that_wants_it",
                                  "complex_views", "transposed_views"])
def test_link_maps_take_the_kernel_on_the_card(link_kernels, fn, case):
    """With the device check faked: under no_grad, or where no input wants
    a gradient, one kernel call a call gives the plain body's result.
    Views of one complex lattice and transposed views reach the kernel at
    their strides (no copy)."""
    x = _link_input(fn)
    n = x.re.shape[2]
    want = _link_call(fn, x)
    link_kernels.card()
    strides = (3 * n, n, 1)
    if case == "no_grad_over_an_input_that_wants_it":
        x = tc.F3(x.re.clone().requires_grad_(), x.im)
    elif case == "complex_views":
        c = torch.complex(x.re, x.im)
        x, strides = tc.F3(c.real, c.imag), (6 * n, 2 * n, 2)
    elif case == "transposed_views":
        x = tc.F3(*(t.transpose(0, 1).contiguous().transpose(0, 1)
                    for t in x))
        strides = (n, 3 * n, 1)
    if case == "grad_but_no_input_wants_it":
        out = _link_call(fn, x)
    else:
        with torch.no_grad():
            out = _link_call(fn, x)
    extra = (8, 2) if fn == "expm" else ()
    assert link_kernels.calls == [(fn, extra, strides)]
    assert not out.re.requires_grad
    assert torch.equal(out.re, want.re) and torch.equal(out.im, want.im)


def test_flow_step_takes_the_link_kernels_on_the_card(link_kernels,
                                                      kernel_calls):
    """A Wilson-flow step under no_grad with the device check faked: 3
    force, 3 expm (order 8, s 2) and 1 reunit kernel calls, and the plain
    step's result."""
    from l2hmc_torch.ops import wilson_flow as wf
    g = torch.Generator().manual_seed(4)
    x = tc.reunit(tc.from_complex_lattice(
        su3g.random((NB, 4, *LAT, 3, 3), g, C128, "cpu")))
    want = wf.flow_step(x, 0.1, LAT, NB)
    link_kernels.card()
    with torch.no_grad():
        out = wf.flow_step(x, 0.1, LAT, NB)
    assert link_kernels.calls == [("expm", (8, 2), (3 * x.re.shape[2],
                                                    x.re.shape[2], 1))] * 3 \
        + [("reunit", (), (3 * x.re.shape[2], x.re.shape[2], 1))]
    assert len(kernel_calls) == 3
    for a, b in ((out[0].re, want[0].re), (out[0].im, want[0].im),
                 (out[1], want[1])):
        assert torch.equal(a, b)


def test_su3_leapfrog_step_takes_the_link_kernels_on_the_card(
        link_kernels, kernel_calls):
    """One SU(3) leapfrog step of the dynamics (a single-direction
    transition of one step) under no_grad with the device check faked: 1
    expm and 2 reunit kernel calls (the second x half-update reuses the
    first's drift), 2 force kernel calls, and the plain transition's
    result."""
    from l2hmc_torch.configs import get_config
    from l2hmc_torch.models.dynamics import State
    from l2hmc_torch.train.trainer import Trainer
    cfg = get_config(["dynamics.nchains=2", "dynamics.latvolume=[2, 2, 2, 2]",
                      "dynamics.nleapfrog=1", "network.units=[4]",
                      "precision=float64", "seed=5"], group="SU3")
    dyn = Trainer(cfg, device="cpu").dynamics
    g = torch.Generator().manual_seed(2)
    x = dyn.random_x(g)
    state = State(x, dyn.random_v(x, g), 5.7)
    with torch.no_grad():
        want, want_sld = dyn.transition_kernel(state, True)
        link_kernels.card()
        out, sld = dyn.transition_kernel(state, True)
    assert link_kernels.names() == ["expm", "reunit", "reunit"]
    assert len(kernel_calls) == 2
    assert torch.equal(out.x, want.x) and torch.equal(out.v, want.v)
    assert torch.equal(sld, want_sld)
