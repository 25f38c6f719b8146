"""The port's SU(3) dynamics against the JAX package's, from the same
weights, per-link masks, x, v and uniforms (2^4, 2 chains, complex128 on
the CPU, the JAX side op by op): proposal, sumlogdet, acc and out x to
1e-9 (a trajectory of force evaluations, order-8 exponentials and
reunits, each agreeing to ~1e-14); plus the invariants of
tests/test_dynamics.py on the port alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_torch.models.dynamics import State as TState
from l2hmc_torch.ops import su3 as tg
from l2hmc_tpu.models.dynamics import State as JState
from torch_parity import (compiled_c1_force, eager, fb_draws,  # noqa: F401
                          hmc_draws, make_su3, su3_fields, to_torch)

torch.set_num_threads(1)

TOL = 1e-9


def _close(t, j, atol=TOL):
    np.testing.assert_allclose(t.detach().resolve_conj().numpy(),
                               np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("nlf,c1", [(2, 0.0), (1, -0.331)],
                         ids=["wilson_nlf2", "c1"])
def test_apply_transition_fb_matches(eager, compiled_c1_force, nlf, c1):
    dyn, params, masks, tdyn = make_su3(nlf=nlf, c1=c1)
    assert tdyn.xnets_first is None and tdyn.masks.shape == (nlf, 4 * 16)
    x, _ = su3_fields(seed=11)
    key = jax.random.PRNGKey(12)
    beta = 5.7
    jx, jm = dyn.apply_transition_fb(params, masks, x, beta, key)
    with torch.no_grad():
        tx, tm = tdyn.apply_transition_fb(to_torch(x), beta,
                                          **fb_draws(dyn, x, key))
    _close(tm["mc_states"].proposed.x, jm["mc_states"].proposed.x)
    _close(tm["mc_states"].proposed.v, jm["mc_states"].proposed.v)
    _close(tm["sumlogdet"], jm["sumlogdet"])
    _close(tm["acc"], jm["acc"])
    np.testing.assert_array_equal(tm["acc_mask"].numpy(),
                                  np.asarray(jm["acc_mask"]))
    _close(tx, jx)
    assert "h_prop" not in tm and "h_init_partial" not in tm
    # the carried traces give the same acceptance as the full Hamiltonians
    mc = tm["mc_states"]
    with torch.no_grad():
        _, sld, _ = tdyn.transition_kernel_fb(mc.init)
        _close(tdyn.compute_accept_prob(mc.init, mc.proposed, sld),
               tm["acc"].numpy(), 1e-10)


@pytest.mark.parametrize("forward", [True, False])
def test_single_direction_kernel_matches(eager, forward):
    dyn, params, masks, tdyn = make_su3(nlf=2)
    x, v = su3_fields(seed=21)
    js, jsld = dyn.transition_kernel(params, masks,
                                     JState(x, v, jnp.asarray(5.7)),
                                     forward=forward)
    with torch.no_grad():
        ts, tsld = tdyn.transition_kernel(
            TState(to_torch(x), to_torch(v), 5.7), forward)
    _close(ts.x, js.x)
    _close(ts.v, js.v)
    _close(tsld, jsld)


def test_apply_transition_single_direction_matches(eager):
    dyn, params, masks, tdyn = make_su3(nlf=1)
    x, _ = su3_fields(seed=23)
    key = jax.random.PRNGKey(24)
    jx, jm = dyn.apply_transition(params, masks, x, 5.7, key)
    k_dir, k_v, k_acc, _ = jax.random.split(key, 4)
    v = dyn.random_v(k_v, x)
    u = jax.random.uniform(k_acc, (2,), dtype=jnp.float64)
    with torch.no_grad():
        tx, tm = tdyn.apply_transition(
            to_torch(x), 5.7, forward=bool(jax.random.bernoulli(k_dir)),
            v=to_torch(v), u=to_torch(u))
    _close(tm["acc"], jm["acc"])
    _close(tx, jx)


def test_hmc_matches_with_plaqs(eager):
    dyn, params, masks, tdyn = make_su3(nlf=2)
    x, _ = su3_fields(seed=31)
    key = jax.random.PRNGKey(32)
    jx, jm = dyn.apply_transition_hmc(x, 5.7, key, eps=0.05)
    with torch.no_grad():
        tx, tm = tdyn.apply_transition_hmc(to_torch(x), 5.7, eps=0.05,
                                           **hmc_draws(dyn, x, key))
    _close(tm["mc_states"].proposed.x, jm["mc_states"].proposed.x)
    _close(tm["acc"], jm["acc"])
    _close(tx, jx)
    _close(tm["plaqs"], jm["plaqs"])
    _close(tm["plaqs_out"], jm["plaqs_out"])
    # the engine's free plaquettes are the observable path's
    _close(tm["plaqs"], tdyn.lattice.plaqs(to_torch(x)).numpy(), 1e-12)
    _close(tm["plaqs_out"], tdyn.lattice.plaqs(tx).numpy(), 1e-12)


def test_su3_reversibility_and_group():
    """fwd kernel then bwd kernel returns the initial state, to < 1e-9,
    and a transition leaves the links on the group."""
    _, _, _, tdyn = make_su3(nlf=2)
    gen = torch.Generator().manual_seed(2)
    x = tdyn.random_x(gen)
    v = tdyn.random_v(x, gen)
    with torch.no_grad():
        s_fwd, sld_f = tdyn.transition_kernel(TState(x, v, 5.7), forward=True)
        s_back, sld_b = tdyn.transition_kernel(s_fwd, forward=False)
        xo, m = tdyn.apply_transition_fb(x, 5.7, gen)
    assert float((s_back.x - x).abs().max()) < 1e-9
    assert float((s_back.v - v).abs().max()) < 1e-9
    assert float((sld_f + sld_b).abs().max()) < 1e-10
    assert float(sld_f.abs().max()) > 0
    assert float(tg.checkSU(xo)[1].max()) < 1e-12
    assert float(tg.checkSU(m["mc_states"].proposed.x)[1].max()) < 1e-12


def test_su3_sumlogdet_convention():
    """sumlogdet counts eps*s/2 once per complex matrix entry (9 per
    link): with the scale head's weight zeroed and its bias set, s is the
    constant tanh(b), and one forward step adds 2 * (eps_v/2) * s * 9 *
    4V."""
    _, _, _, tdyn = make_su3(nlf=1)
    with torch.no_grad():
        for net in tdyn.vnets:
            net.scale.weight.zero_()
            net.scale.bias.fill_(0.3)
    gen = torch.Generator().manual_seed(3)
    x = tdyn.random_x(gen)
    v = tdyn.random_v(x, gen)
    with torch.no_grad():
        _, sld = tdyn.transition_kernel(TState(x, v, 5.7), forward=True)
    eps_v = float(torch.sigmoid(tdyn.veps[0].detach()))
    want = 2 * 0.5 * eps_v * np.tanh(0.3) * 9 * 4 * 16
    np.testing.assert_allclose(sld.numpy(), want, rtol=1e-12)


def test_random_x_cold_and_hot():
    from l2hmc_torch.configs import DynamicsConfig, NetworkConfig
    from l2hmc_torch.models.dynamics import Dynamics
    cfg = DynamicsConfig(nchains=3, group="SU3", latvolume=[2, 2, 2, 2],
                         nleapfrog=1, cold_start=True)
    dyn = Dynamics(cfg, NetworkConfig(units=[4]), dtype=torch.complex64)
    x = dyn.random_x()
    assert x.shape == (3, 4, 2, 2, 2, 2, 3, 3) and x.dtype == torch.complex64
    assert torch.equal(x[1, 2, 0, 1, 0, 1], torch.eye(3, dtype=x.dtype))
    assert dyn.random_x(nchains=2).shape[0] == 2
    cfg.cold_start = False
    hot = dyn.random_x(torch.Generator().manual_seed(0))
    assert float(tg.checkSU(hot)[1].max()) < 1e-3
    assert float((hot - x).abs().max()) > 0.1
    with pytest.raises(ValueError, match="complex"):
        Dynamics(cfg, NetworkConfig(units=[4]), dtype=torch.float32)
