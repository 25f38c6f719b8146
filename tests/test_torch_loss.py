"""The port's U(1) loss, and the gradient of the loss with respect to every
parameter through a whole `apply_transition_fb` (every force evaluation,
the force's backward, the NCP updates, BN with batch statistics), against
jax.grad of the JAX package at float64: to 1e-8 absolute (each gradient
entry is a sum over two trajectories of ~1e2-sized terms that agree to
~1e-15 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_torch.models.loss import LatticeLoss as TLoss
from l2hmc_tpu.configs import DynamicsConfig, LossConfig, NetworkConfig
from l2hmc_tpu.models.dynamics import Dynamics
from l2hmc_tpu.models.loss import LatticeLoss as JLoss
from torch_parity import fb_draws, port_dynamics, to_torch

torch.set_num_threads(1)

LOSS_CONFIGS = {
    "all_terms": LossConfig(charge_weight=0.01, plaq_weight=0.1,
                            rmse_weight=0.1),
    "not_mixed": LossConfig(use_mixed_loss=False, charge_weight=0.01,
                            plaq_weight=0.1),
}


def _grad_pairs(tdyn, jgrads):
    """(name, torch grad, jax grad as the torch layout) for every param."""
    yield "xeps", tdyn.xeps.grad, np.asarray(jgrads.xeps)
    yield "veps", tdyn.veps.grad, np.asarray(jgrads.veps)
    for name in ("vnets", "xnets_first", "xnets_second"):
        tree = getattr(jgrads, name)
        for i, layer in enumerate(getattr(tdyn, name)):
            def g(*path):
                a = tree
                for p in path:
                    a = a[p]
                return np.asarray(a)[i]
            for lname in ("xlayer", "vlayer", "scale", "transl", "transf"):
                lin = getattr(layer, lname)
                yield f"{name}{i}.{lname}.w", lin.weight.grad, g(lname, "w").T
                yield f"{name}{i}.{lname}.b", lin.bias.grad, g(lname, "b")
            for h, lin in enumerate(layer.hidden):
                yield (f"{name}{i}.hidden{h}.w", lin.weight.grad,
                       g("hidden", h, "w").T)
                yield (f"{name}{i}.hidden{h}.b", lin.bias.grad,
                       g("hidden", h, "b"))
            for lname in ("scale", "transf"):
                yield (f"{name}{i}.{lname}.coeff",
                       getattr(layer, lname).coeff.grad, g(lname, "coeff"))
            yield f"{name}{i}.bn.gamma", layer.bn.gamma.grad, g("bn", "gamma")
            yield f"{name}{i}.bn.beta", layer.bn.beta.grad, g("bn", "beta")


@pytest.mark.parametrize("name", list(LOSS_CONFIGS))
def test_loss_grad_through_trajectory(name):
    lcfg = LOSS_CONFIGS[name]
    cfg = DynamicsConfig(nchains=8, group="U1", latvolume=[4, 4],
                         nleapfrog=2, eps=0.1, use_ncp=True,
                         merge_directions=True)
    netcfg = NetworkConfig(units=[8, 8], activation_fn="leaky_relu",
                           dropout_prob=0.0, use_batch_norm=True)
    dyn = Dynamics(cfg, netcfg, dtype=jnp.float64)
    params, masks = dyn.init_params(jax.random.PRNGKey(3))
    x = dyn.random_x(jax.random.PRNGKey(4))
    key = jax.random.PRNGKey(5)
    beta = 2.0
    jloss_fn = JLoss(dyn.lattice, lcfg)

    def loss_of(p):
        _, m = dyn.apply_transition_fb(p, masks, x, beta, key, training=True)
        mc = m["mc_states"]
        return jloss_fn.calc_loss(mc.init.x, mc.proposed.x, m["acc"])

    jloss, jgrads = jax.value_and_grad(loss_of)(params)

    tdyn = port_dynamics(dyn, params, masks)
    tloss_fn = TLoss(tdyn.lattice, lcfg)
    _, tm = tdyn.apply_transition_fb(to_torch(x), beta, training=True,
                                     **fb_draws(dyn, x, key, training=True))
    mc = tm["mc_states"]
    tloss = tloss_fn.calc_loss(mc.init.x, mc.proposed.x, tm["acc"])
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-12)
    n = 0
    for pname, tg, jg in _grad_pairs(tdyn, jgrads):
        assert tg is not None, pname
        np.testing.assert_allclose(tg.numpy(), jg, atol=1e-8, rtol=0,
                                   err_msg=pname)
        n += 1
    assert n == len(list(tdyn.parameters()))


def test_lattice_metrics_match():
    cfg = DynamicsConfig(nchains=8, group="U1", latvolume=[6, 4],
                         nleapfrog=1)
    netcfg = NetworkConfig(units=[4])
    dyn = Dynamics(cfg, netcfg, dtype=jnp.float64)
    x1 = dyn.random_x(jax.random.PRNGKey(1))
    x2 = dyn.random_x(jax.random.PRNGKey(2))
    tdyn = port_dynamics(dyn, *dyn.init_params(jax.random.PRNGKey(0)))
    jm = JLoss(dyn.lattice, LossConfig()).lattice_metrics(x1, x2)
    tm = TLoss(tdyn.lattice, LossConfig()).lattice_metrics(to_torch(x1),
                                                           to_torch(x2))
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-12, rtol=0, err_msg=k)


def test_finite_or_zero_drops_diverged_chain():
    lat = port_dynamics(*_tiny()).lattice
    x1 = torch.zeros(3, 2 * 6 * 4, dtype=torch.float64)
    x2 = x1 + 0.3
    x2[1, 0] = float("nan")
    loss = TLoss(lat, LossConfig(use_mixed_loss=False, rmse_weight=1.0,
                                 charge_weight=0.0))
    val = loss.calc_loss(x1, x2, torch.ones(3, dtype=torch.float64))
    assert torch.isfinite(val)


def _tiny():
    cfg = DynamicsConfig(nchains=3, group="U1", latvolume=[6, 4],
                         nleapfrog=1)
    dyn = Dynamics(cfg, NetworkConfig(units=[4]), dtype=jnp.float64)
    params, masks = dyn.init_params(jax.random.PRNGKey(0))
    return dyn, params, masks
