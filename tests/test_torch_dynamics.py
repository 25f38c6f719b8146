"""The port's U(1) dynamics against the JAX package's, from the same
weights, masks, x, v, uniforms and dropout masks, at float64 on the CPU
(to 1e-10: a whole trajectory of tan/atan/exp updates and network calls,
each agreeing to ~1e-15), plus the physics invariants of
tests/test_dynamics.py on the port alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_torch.models.dynamics import State as TState
from l2hmc_torch.utils import mh as tmh
from l2hmc_tpu.configs import DynamicsConfig, NetworkConfig
from l2hmc_tpu.models.dynamics import Dynamics
from l2hmc_tpu.utils import mh as jmh
from torch_parity import fb_draws, hmc_draws, port_dynamics, to_torch

torch.set_num_threads(1)

TOL = 1e-10


def make(nlf=2, lat=(4, 4), nchains=6, use_bn=True, dropout=0.0,
         split=True, separate=True, seed=0):
    cfg = DynamicsConfig(nchains=nchains, group="U1", latvolume=list(lat),
                         nleapfrog=nlf, eps=0.1, use_ncp=True,
                         merge_directions=True, use_split_xnets=split,
                         use_separate_networks=separate)
    netcfg = NetworkConfig(units=[8, 8], activation_fn="tanh",
                           dropout_prob=dropout, use_batch_norm=use_bn)
    dyn = Dynamics(cfg, netcfg, dtype=jnp.float64)
    params, masks = dyn.init_params(jax.random.PRNGKey(seed))
    if use_bn:
        # non-trivial running statistics for the eval-mode (running BN) path
        def bump(net):
            bn = dict(net["bn"])
            bn["r_mean"] = bn["r_mean"] + 0.1
            bn["r_var"] = bn["r_var"] * 1.5
            return {**net, "bn": bn}
        params = params._replace(
            vnets=bump(params.vnets), xnets_first=bump(params.xnets_first),
            xnets_second=(bump(params.xnets_second) if split else None))
    return dyn, params, masks, port_dynamics(dyn, params, masks)


def _close(t, j, atol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("training,dropout,split,separate", [
    (False, 0.0, True, True),
    (True, 0.2, True, True),
    (True, 0.0, False, False),
], ids=["eval", "train_dropout", "shared_nets"])
def test_apply_transition_fb_matches(training, dropout, split, separate):
    dyn, params, masks, tdyn = make(dropout=dropout, split=split,
                                    separate=separate)
    x = dyn.random_x(jax.random.PRNGKey(11))
    key = jax.random.PRNGKey(12)
    beta = 2.5
    jx, jm = dyn.apply_transition_fb(params, masks, x, beta, key,
                                     training=training)
    draws = fb_draws(dyn, x, key, training=training)
    tx, tm = tdyn.apply_transition_fb(to_torch(x), beta, training=training,
                                      **draws)
    _close(tm["mc_states"].proposed.x, jm["mc_states"].proposed.x)
    _close(tm["mc_states"].proposed.v, jm["mc_states"].proposed.v)
    _close(tm["sumlogdet"], jm["sumlogdet"])
    _close(tm["acc"], jm["acc"])
    np.testing.assert_array_equal(tm["acc_mask"].numpy(),
                                  np.asarray(jm["acc_mask"]))
    _close(tx, jx)
    if training:
        jbn = jm["bn_stats"]
        tbn = tm["bn_stats"]
        # JAX stacks per-step stats over the 2*nlf scan steps (fwd, bwd)
        assert len(tbn) == 2 * dyn.nlf
        for s, (k, bn) in enumerate(tbn):
            assert k == int(jbn["idx"][s])
            _close(bn["v"][0][0], jbn["v"][0][0][s])
            _close(bn["x1"][1], jbn["x1"][1][s])


def test_apply_transition_hmc_matches():
    dyn, params, masks, tdyn = make()
    x = dyn.random_x(jax.random.PRNGKey(21))
    key = jax.random.PRNGKey(22)
    jx, jm = dyn.apply_transition_hmc(x, 3.0, key)
    tx, tm = tdyn.apply_transition_hmc(to_torch(x), 3.0,
                                       **hmc_draws(dyn, x, key))
    _close(tm["mc_states"].proposed.x, jm["mc_states"].proposed.x)
    _close(tm["acc"], jm["acc"])
    _close(tm["sumlogdet"], jm["sumlogdet"])
    _close(tx, jx)


def test_single_direction_kernel_matches():
    dyn, params, masks, tdyn = make()
    x = dyn.random_x(jax.random.PRNGKey(31))
    v = dyn.random_v(jax.random.PRNGKey(32), x)
    for forward in (True, False):
        js, jsld = dyn.transition_kernel(params, masks,
                                         jax_state(x, v), forward=forward)
        ts, tsld = tdyn.transition_kernel(
            TState(to_torch(x), to_torch(v), 1.0), forward)
        _close(ts.x, js.x)
        _close(ts.v, js.v)
        _close(tsld, jsld)


def jax_state(x, v):
    from l2hmc_tpu.models.dynamics import State
    return State(x, v, jnp.asarray(1.0))


def test_u1_reversibility():
    """fwd kernel then bwd kernel returns the initial state (reference
    test_reversibility, dynamics.py:813-819)."""
    _, _, _, tdyn = make(nlf=3)
    gen = torch.Generator().manual_seed(2)
    x = tdyn.random_x(gen)
    v = tdyn.random_v(x, gen)
    with torch.no_grad():
        s_fwd, _ = tdyn.transition_kernel(TState(x, v, 1.0), forward=True)
        s_back, _ = tdyn.transition_kernel(s_fwd, forward=False)
    dx = torch.angle(torch.exp(1j * (s_back.x - x))).abs()
    assert float(dx.max()) < 1e-10
    assert float((s_back.v - v).abs().max()) < 1e-10


def test_u1_sumlogdet_is_exact_jacobian():
    """sumlogdet of the fwd kernel == log|det d(x',v')/d(x,v)| from a
    numerical (autograd) Jacobian on a tiny system."""
    _, _, _, tdyn = make(nlf=2, lat=(2, 2), nchains=1, use_bn=False)
    xdim = tdyn.xdim
    gen = torch.Generator().manual_seed(6)
    x0 = tdyn.random_x(gen)
    v0 = tdyn.random_v(x0, gen)

    def fwd_map(xv):
        s, _ = tdyn.transition_kernel(
            TState(xv[:xdim].reshape(1, xdim), xv[xdim:].reshape(1, xdim),
                   1.0), forward=True)
        return torch.cat([s.x.ravel(), s.v.ravel()])

    xv0 = torch.cat([x0.ravel(), v0.ravel()])
    jac = torch.autograd.functional.jacobian(fwd_map, xv0)
    sign, logdet = torch.linalg.slogdet(jac)
    with torch.no_grad():
        _, sld = tdyn.transition_kernel(TState(x0, v0, 1.0), forward=True)
    assert float(sign) > 0
    np.testing.assert_allclose(float(sld[0]), float(logdet), atol=1e-8)


def test_fb_sumlogdet_roundtrip_zero():
    _, _, _, tdyn = make(nlf=2, lat=(2, 2), nchains=3, use_bn=False)
    gen = torch.Generator().manual_seed(8)
    x = tdyn.random_x(gen)
    v = tdyn.random_v(x, gen)
    with torch.no_grad():
        s_fwd, sld_f = tdyn.transition_kernel(TState(x, v, 1.0),
                                              forward=True)
        _, sld_b = tdyn.transition_kernel(s_fwd, forward=False)
    assert float((sld_f + sld_b).abs().max()) < 1e-10


def test_mh_nonfinite_rejects():
    dh = np.array([0.3, -1.0, np.nan, np.inf, -np.inf])
    np.testing.assert_allclose(tmh.accept_prob(torch.from_numpy(dh)),
                               np.asarray(jmh.accept_prob(jnp.asarray(dh))),
                               atol=1e-15, rtol=0)
    prop = torch.tensor([[np.nan, 1.0], [2.0, 3.0]])
    init = torch.zeros(2, 2)
    out = tmh.select(torch.tensor([0.0, 1.0]), prop, init)
    assert torch.equal(out, torch.tensor([[0.0, 0.0], [2.0, 3.0]]))
