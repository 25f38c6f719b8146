"""The port's SU(3) loss, and its gradient with respect to every parameter
through a whole SU(3) `apply_transition_fb` (force evaluations, order-8
exponentials, reunits, the carried-trace acceptance), against jax.grad of
the JAX package at complex128, the JAX side op by op: for the SU(3)
default loss (plaq + rmse) and for the flowed clover-charge loss (one RK3
flow step, under both checkpoints), rtol 1e-7 (atol 1e-12 for entries
that are zero up to rounding)."""
import jax
import numpy as np
import pytest
import torch

from l2hmc_torch.configs import LossConfig as TLossConfig
from l2hmc_torch.models.loss import LatticeLoss as TLoss
from l2hmc_tpu.configs import LossConfig
from l2hmc_tpu.models.loss import LatticeLoss as JLoss
from torch_parity import (eager, fb_draws, grad_pairs, make_su3,  # noqa: F401
                          su3_fields, to_torch)

torch.set_num_threads(1)

LOSS_CONFIGS = {
    "default_plaq_rmse": dict(use_mixed_loss=False, charge_weight=0.0,
                              plaq_weight=0.1, rmse_weight=0.1),
    "flowed_charge_mixed": dict(use_mixed_loss=True, charge_weight=0.01,
                                charge_flow_nsteps=1, charge_flow_eps=0.1),
}


@pytest.fixture(scope="module")
def trajectory():
    """The JAX side of one differentiated SU(3) `apply_transition_fb`,
    linearised once and shared by the loss cases: (dyn, port dynamics, x,
    the draws, init x, proposed x, acc, the pullback to the parameters).
    The slow part, the trajectory op by op, runs once per module."""
    with jax.disable_jit():
        dyn, params, masks, tdyn = make_su3(nlf=1)
        x, _ = su3_fields(seed=4)
        key = jax.random.PRNGKey(5)

        def run(p):
            _, m = dyn.apply_transition_fb(p, masks, x, 5.7, key,
                                           training=True)
            mc = m["mc_states"]
            return mc.init.x, mc.proposed.x, m["acc"]

        out, pullback = jax.vjp(run, params)
        draws = fb_draws(dyn, x, key, training=True)
    return dyn, tdyn, x, draws, out, pullback


@pytest.mark.parametrize("name", list(LOSS_CONFIGS))
def test_su3_loss_grad_through_trajectory(eager, trajectory, name):
    dyn, tdyn, x, draws, out, pullback = trajectory
    beta = 5.7
    jloss_fn = JLoss(dyn.lattice, LossConfig(**LOSS_CONFIGS[name]))
    # jax.grad of the loss through the trajectory, by the chain rule: the
    # loss's cotangents on the trajectory's outputs, pulled back
    jloss, cts = jax.value_and_grad(jloss_fn.calc_loss, argnums=(0, 1, 2))(
        *out)
    (jgrads,) = pullback(cts)

    tdyn.zero_grad(set_to_none=True)
    tloss_fn = TLoss(tdyn.lattice, TLossConfig(**LOSS_CONFIGS[name]))
    _, tm = tdyn.apply_transition_fb(to_torch(x), beta, training=True,
                                     **draws)
    mc = tm["mc_states"]
    tloss = tloss_fn.calc_loss(mc.init.x, mc.proposed.x, tm["acc"])
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-10)
    n, biggest = 0, 0.0
    for pname, tgrad, jgrad in grad_pairs(tdyn, jgrads):
        assert tgrad is not None, pname
        assert torch.isfinite(tgrad).all(), pname
        np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-7,
                                   atol=1e-12, err_msg=pname)
        biggest = max(biggest, float(tgrad.abs().max()))
        n += 1
    assert n == len(list(tdyn.parameters()))
    assert biggest > 1e-6


def test_su3_loss_terms_and_metrics_match(eager, trajectory):
    dyn, tdyn = trajectory[:2]
    x1, _ = su3_fields(seed=6)
    x2, _ = su3_fields(seed=7)
    acc = np.array([0.3, 0.9])
    for kw in (dict(use_mixed_loss=True, charge_weight=0.01, plaq_weight=0.1,
                    rmse_weight=0.1),
               dict(use_mixed_loss=False, charge_weight=0.01,
                    charge_flow_nsteps=2, charge_flow_eps=0.05)):
        jl = JLoss(dyn.lattice, LossConfig(**kw))
        tl = TLoss(tdyn.lattice, TLossConfig(**kw))
        np.testing.assert_allclose(
            float(tl(to_torch(x1), to_torch(x2), torch.from_numpy(acc))),
            float(jl(x1, x2, jax.numpy.asarray(acc))), rtol=1e-10)
    jm = jl.lattice_metrics(x1, x2)
    tm = tl.lattice_metrics(to_torch(x1), to_torch(x2))
    assert tm.keys() == jm.keys() == {"plaqs", "intQ", "sinQ", "dQint",
                                      "dQsin"}
    for k in tm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-12, rtol=0, err_msg=k)
    np.testing.assert_allclose(
        tl._flowed_clover_charge(to_torch(x1)).numpy(),
        np.asarray(jl._flowed_clover_charge(x1)), atol=1e-12)


def test_su3_finite_or_zero_drops_diverged_chain():
    _, _, _, tdyn = make_su3(nlf=1)
    x1 = tdyn.random_x(torch.Generator().manual_seed(0))
    x2 = tdyn.random_x(torch.Generator().manual_seed(1))
    x2[1, 0, 0, 0, 0, 0, 0, 0] = float("nan")
    loss = TLoss(tdyn.lattice, TLossConfig(use_mixed_loss=False,
                                           charge_weight=0.0,
                                           plaq_weight=0.1, rmse_weight=0.1))
    assert torch.isfinite(loss(x1, x2, torch.ones(2, dtype=torch.float64)))


def test_charge_flow_without_charge_weight_raises():
    """The guard of the configs: a flowed charge loss with the charge term
    switched off is an error, not a silent no-op."""
    with pytest.raises(ValueError, match="charge_weight"):
        TLossConfig(charge_weight=0.0, charge_flow_nsteps=2)
    from l2hmc_torch.configs import get_config
    with pytest.raises(ValueError, match="charge_weight"):
        get_config(["loss.charge_flow_nsteps=2"], group="SU3")
    assert get_config(["loss.charge_flow_nsteps=2",
                       "loss.charge_weight=0.01"],
                      group="SU3").loss.charge_flow_nsteps == 2
