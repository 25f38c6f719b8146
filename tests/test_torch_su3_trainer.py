"""One SU(3) train step of the port's Trainer against the JAX package's,
from the same state and draws (2^4, 2 chains, complex128, the JAX side op
by op): loss and grad_norm to rtol 1e-9, params and Adam moments to 1e-8
(Adam's first update is ~lr * sign(g), so the params inherit the
gradients' agreement scaled by lr / (|g| + eps)); the regression gate
grad_norm > 0 with no non-finite entry; with lr 0 the same step moves no
parameter in either package; the same JAX step against the
port's Trainer on a (2, 2) mesh of four gloo processes (the lattice split
in t, the chains over 'data'), at the same tolerances; and the flowed
eval observables (tests/test_flow_eval.py)."""
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

from l2hmc_torch.configs import get_config as tget_config
from l2hmc_torch.train.trainer import Trainer as TTrainer
from l2hmc_tpu.configs import get_config
from l2hmc_tpu.train.trainer import Trainer
from torch_dist_workers import spawn
from torch_parity import (eager, fb_draws, grad_pairs,  # noqa: F401
                          params_to_numpy, to_torch)

torch.set_num_threads(1)

BASE = [
    "dynamics.nchains=2", "dynamics.latvolume=[2, 2, 2, 2]",
    "dynamics.nleapfrog=1", "dynamics.eps=0.05", "network.units=[4]",
    "precision=float64", "steps.nera=1", "steps.nepoch=2", "steps.test=2",
    "learning_rate.clip_norm=1.0",
]


def _adam_state(opt_state):
    (adam,) = [n for n in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(n, "mu")]
    return adam


@pytest.fixture(scope="module")
def jax_step():
    """The JAX Trainer's first train step, its initial weights and the
    draws it makes, once for the module."""
    jtr = Trainer(get_config(BASE, group="SU3"))
    # the initial state is an input here: jitted, it is ready in a few
    # seconds, and the step under test runs op by op
    ts0, x = jtr.init_state(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(10)
    k_main = jax.random.split(key, 3)[0]
    draws = fb_draws(jtr.dynamics, x, k_main, training=True)
    with jax.disable_jit():
        ts, jx, jm = jtr.train_step(ts0, x, 6.0, key)
    return SimpleNamespace(ts0=ts0, params=params_to_numpy(ts0.params),
                           masks=np.asarray(ts0.masks), x=x, draws=draws,
                           ts=ts, jx=jx, jm=jm)


def _port_trainer(js):
    ttr = TTrainer(tget_config(BASE, group="SU3"), device="cpu")
    assert ttr.dtype == torch.complex128
    ttr.dynamics.load_jax_params(js.params, js.masks)
    return ttr


def _step_matches(tx, tm, js, keys=("plaqs", "intQ", "sinQ", "dQint",
                                    "checkSU_mean", "checkSU_max", "acc")):
    jm = js.jm
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-9)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-9)
    assert float(tm["grad_norm"]) > 0
    assert int(tm["grad_nonfinite"]) == int(jm["grad_nonfinite"]) == 0
    np.testing.assert_allclose(tx.numpy(), np.asarray(js.jx), atol=1e-9,
                               rtol=0)
    for k in keys:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-9, rtol=0, err_msg=k)


def test_su3_train_step_matches(jax_step):
    ttr = _port_trainer(jax_step)
    ts = jax_step.ts
    tx, tm = ttr.train_step(to_torch(jax_step.x), 6.0, draws=jax_step.draws)
    _step_matches(tx, tm, jax_step)
    adam = _adam_state(ts.opt_state)
    n = 0
    moments = {"exp_avg": dict((a, c) for a, _, c in
                               grad_pairs(ttr.dynamics, adam.mu, None)),
               "exp_avg_sq": dict((a, c) for a, _, c in
                                  grad_pairs(ttr.dynamics, adam.nu, None))}
    for name, t, j in grad_pairs(ttr.dynamics, ts.params, None):
        np.testing.assert_allclose(t.detach().numpy(), j, atol=1e-8, rtol=0,
                                   err_msg=name)
        for mk, table in moments.items():
            np.testing.assert_allclose(
                ttr.optimizer.state[t][mk].numpy(), table[name], atol=1e-8,
                rtol=0, err_msg=f"{name} {mk}")
        n += 1
    assert n == len(list(ttr.dynamics.parameters()))


def test_su3_train_step_with_lr_0_moves_no_parameter(jax_step):
    """learning_rate.lr_init=0, as the `*_frozen` records run: the port's
    step computes the JAX step's loss, gradient norm (> 0), sumlogdet, x
    and metrics, and leaves every parameter bit-equal after its Adam
    update; the JAX package's lr-0 optax chain, fed that step's gradient,
    leaves its parameters bit-equal too. The step before the update reads
    no lr, so the module's JAX step stands for the lr-0 one."""
    lr0 = BASE + ["learning_rate.lr_init=0"]
    ttr = TTrainer(tget_config(lr0, group="SU3"), device="cpu")
    ttr.dynamics.load_jax_params(jax_step.params, jax_step.masks)
    before = {n: p.detach().clone()
              for n, p in ttr.dynamics.named_parameters()}
    tx, tm = ttr.train_step(to_torch(jax_step.x), 6.0, draws=jax_step.draws)
    _step_matches(tx, tm, jax_step, keys=(
        "sumlogdet", "plaqs", "intQ", "sinQ", "dQint", "acc"))
    assert ttr.updates == 1
    assert ttr.optimizer.param_groups[0]["lr"] == 0.0
    for n, p in ttr.dynamics.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    jtx = Trainer(get_config(lr0, group="SU3")).tx
    p0 = jax_step.ts0.params
    upd, _ = jtx.update(jax_step.jm["grads"], jtx.init(p0), p0)
    leaves = jax.tree_util.tree_leaves
    for a, b in zip(leaves(optax.apply_updates(p0, upd)), leaves(p0)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_su3_sharded_train_step_matches(jax_step, tmp_path):
    """The port's Trainer on a (2, 2) mesh (ShardedTrainerSU3: one t row
    and one chain a rank) from the JAX step's weights and draws: loss,
    grad_norm, x, the per-chain metrics and the updated parameters as the
    single-device port is held above."""
    ttr = _port_trainer(jax_step)
    torch.save({"overrides": BASE, "state": ttr.dynamics.state_dict(),
                "x": to_torch(jax_step.x), "draws": jax_step.draws,
                "beta": 6.0}, tmp_path / "inputs.pt")
    spawn(str(tmp_path), 4, "sharded_train_step",
          inputs=str(tmp_path / "inputs.pt"), out=str(tmp_path / "out.pt"),
          mesh_shape=(2, 2))
    got = torch.load(tmp_path / "out.pt")
    _step_matches(got["x"], got["metrics"], jax_step)
    ttr.dynamics.load_state_dict(got["state"])
    n = 0
    for name, t, j in grad_pairs(ttr.dynamics, jax_step.ts.params, None):
        np.testing.assert_allclose(t.detach().numpy(), j, atol=1e-8, rtol=0,
                                   err_msg=name)
        n += 1
    assert n == len(list(ttr.dynamics.parameters()))


FLOW = BASE + ["precision=float32", "flow_eps=0.05", "nchains=2"]


@pytest.mark.parametrize("flow_nsteps", [2, 0])
def test_eval_emits_flow_metrics_only_when_asked(flow_nsteps):
    tr = TTrainer(tget_config(FLOW + [f"flow_nsteps={flow_nsteps}"],
                              group="SU3"), device="cpu")
    assert tr.dtype == torch.complex64
    gen = torch.Generator().manual_seed(0)
    for job in ("eval", "hmc"):
        tr.evaluate(gen, job_type=job, nsteps=2)
        h = tr.histories[job].get_dataset()
        for k in ("flowQ", "flow_plaq", "flow_t2E"):
            assert (k in h) == (flow_nsteps > 0), (job, k)
        if flow_nsteps:
            assert h["flowQ"].shape == (2, 2)
            assert np.isfinite(h["flowQ"]).all()
            assert (h["flow_plaq"] > h["plaqs"]).all()   # the flow smooths
            assert (h["flow_t2E"] >= 0).all()
    assert "plaqs" in tr.histories["hmc"].get_dataset()


def test_flow_metrics_match_reference(eager):
    overrides = BASE + ["flow_nsteps=2", "flow_eps=0.05"]
    jtr = Trainer(get_config(overrides, group="SU3"))
    ttr = TTrainer(tget_config(overrides, group="SU3"), device="cpu")
    x = jtr.dynamics.random_x(jax.random.PRNGKey(3))
    jf, tf = jtr._flow_metrics(x), ttr._flow_metrics(to_torch(x))
    assert tf.keys() == jf.keys()
    for k in tf:
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]),
                                   atol=1e-10, rtol=0, err_msg=k)


def test_su3_warmup_stops_on_stationarity_and_mesh_raises():
    tr = TTrainer(tget_config(FLOW, group="SU3"), device="cpu")
    calls = []
    real = tr.hmc_step

    def counted(*a, **k):
        calls.append(1)
        x, m = real(*a, **k)
        m["plaqs"] = torch.full_like(m["plaqs"], 0.5)   # flat series
        return x, m
    tr.hmc_step = counted
    x = tr.dynamics.random_x(torch.Generator().manual_seed(1))
    tr.warmup(x, 6.0, torch.Generator().manual_seed(2), nsteps=40)
    assert len(calls) == 10           # two 5-step windows, then stationary
    calls.clear()
    tr.warmup(x, 6.0, torch.Generator().manual_seed(2), nsteps=12, exact=True)
    assert len(calls) == 12
    # a mesh wants as many processes as it has ranks: one process here
    from l2hmc_torch.experiment import Experiment
    with pytest.raises(ValueError, match="needs 4 processes"):
        Experiment(tget_config(FLOW + ["mesh_shape=[2, 2]"], group="SU3"),
                   device="cpu")
