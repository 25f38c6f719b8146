"""Train steps of the port's Trainer against the JAX package's, from the
same state and the same draws (replayed from the key splits of
`_train_step_impl`, trainer.py:219, then dynamics.py:885), at float64 on
the CPU: params, Adam moments and BN running statistics to 1e-8 (Adam's
first update is ~lr * sign(g), so the params inherit the gradients'
~1e-12 agreement scaled by lr / (|g| + eps)). The `record_64x64_knobs`
case takes the U(1) 64x64 record's dynamics (nleapfrog 4, eps 0.025,
beta 4, BN and dropout on) at 8x8 for 10 steps in lockstep, where a drift
of a few ulps a step compounded through Adam would show."""
import json

import jax
import numpy as np
import pytest
import torch

from l2hmc_torch.configs import get_config as tget_config
from l2hmc_torch.train.trainer import Trainer as TTrainer
from l2hmc_tpu.configs import get_config
from l2hmc_tpu.train.trainer import Trainer
from torch_parity import fb_draws, params_to_numpy, to_torch

torch.set_num_threads(1)

BASE = [
    "dynamics.nchains=8", "dynamics.latvolume=[4, 4]",
    "dynamics.nleapfrog=2", "dynamics.eps=0.1", "network.units=[8, 8]",
    "network.use_batch_norm=true", "network.dropout_prob=0.2",
    "precision=float64", "steps.nera=1", "steps.nepoch=2", "steps.test=2",
]

#: name -> (overrides, train steps, beta)
VARIANTS = {
    "default": ([], 2, 2.0),
    "clip_warmup_epsfixed": (["learning_rate.clip_norm=0.5",
                              "learning_rate.warmup=3",
                              "dynamics.eps_fixed=true"], 2, 2.0),
    "noam_accum": (["learning_rate.schedule=noam", "learning_rate.warmup=4",
                    "grad_accum_steps=2"], 2, 2.0),
    "record_64x64_knobs": (["dynamics.latvolume=[8, 8]",
                            "dynamics.nleapfrog=4", "dynamics.eps=0.025",
                            "steps.nepoch=10"], 10, 4.0),
}


def _adam_state(opt_state):
    (adam,) = [n for n in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(n, "mu")]
    return adam


def _pairs(tdyn, tree):
    """(name, torch tensor, JAX array in the torch layout) for every param
    and BN buffer."""
    yield "xeps", tdyn.xeps, np.asarray(tree.xeps)
    yield "veps", tdyn.veps, np.asarray(tree.veps)
    for name in ("vnets", "xnets_first", "xnets_second"):
        jt = getattr(tree, name)
        for i, layer in enumerate(getattr(tdyn, name)):
            for key, t in layer.state_dict(keep_vars=True).items():
                parts = key.split(".")
                if parts[0] == "hidden":
                    a = jt["hidden"][int(parts[1])]
                    parts = parts[2:]
                else:
                    a = jt[parts[0]]
                    parts = parts[1:]
                leaf = {"weight": "w", "bias": "b"}.get(parts[0], parts[0])
                arr = np.asarray(a[leaf])[i]
                yield f"{name}{i}.{key}", t, arr.T if leaf == "w" else arr


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_steps_match(variant):
    extra, nsteps, beta = VARIANTS[variant]
    overrides = BASE + extra
    jtr = Trainer(get_config(overrides))
    ts, x = jtr.init_state(jax.random.PRNGKey(0))
    ttr = TTrainer(tget_config(overrides), device="cpu")
    ttr.dynamics.load_jax_params(params_to_numpy(ts.params),
                                 np.asarray(ts.masks))
    tx = to_torch(x)
    for step in range(nsteps):
        key = jax.random.PRNGKey(10 + step)
        k_main = jax.random.split(key, 3)[0]
        draws = fb_draws(jtr.dynamics, x, k_main, training=True)
        ts, x, jm = jtr.train_step(ts, x, beta, key)
        tx, tm = ttr.train_step(tx, beta, draws=draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-10)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-10)
        assert int(tm["grad_nonfinite"]) == int(jm["grad_nonfinite"]) == 0
        np.testing.assert_allclose(tx.numpy(), np.asarray(x), atol=1e-10,
                                   rtol=0)
    adam = _adam_state(ts.opt_state)
    n_adam = 0
    for name, t, j in _pairs(ttr.dynamics, ts.params):
        np.testing.assert_allclose(t.detach().numpy(), j, atol=1e-8, rtol=0,
                                   err_msg=name)
        if isinstance(t, torch.nn.Parameter):
            st = ttr.optimizer.state[t]
            for tk, jtree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                _, _, jv = next(p for p in _pairs(ttr.dynamics, jtree)
                                if p[0] == name)
                np.testing.assert_allclose(st[tk].numpy(), jv, atol=1e-8,
                                           rtol=0, err_msg=f"{name} {tk}")
            n_adam += 1
    assert n_adam == len(list(ttr.dynamics.parameters()))
    assert ttr.updates == nsteps // ttr.grad_accum_steps


def test_profile_takes_unlogged_steps_and_writes_a_trace(tmp_path):
    """Trainer.profile (JAX trainer.py:496-512): nsteps train steps under
    torch.profiler, none logged, one Chrome trace under outdir, the
    advanced x returned."""
    ttr = TTrainer(tget_config(BASE), device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = ttr.random_x(gen)
    y = ttr.profile(x, 2.0, gen, nsteps=2, outdir=str(tmp_path / "prof"))
    assert y.shape == x.shape and not torch.equal(y, x)
    assert ttr.step == 2 and ttr.updates == 2
    assert ttr.histories["train"].get_dataset() == {}
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name == "trace_step2.json"
    with open(trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
