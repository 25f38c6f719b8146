"""Train steps of the JAX package and the port in lockstep, at the U(1)
64x64 bf16 record's dynamics (`quality.U1_64X64_BF16`) in float64 on the
CPU: the same start, weights and injected draws, one line per step with
|loss difference| / |loss|, |grad_norm difference| / grad_norm, the
largest parameter difference, the largest x difference (angles mod 2 pi),
both mean acceptances and the chains whose Metropolis-Hastings decision
differs. A step where the decisions differ restarts the port from the
JAX state (weights, BN statistics, Adam moments, x).

    JAX_PLATFORMS=cpu python tests/torch_lockstep.py [NSTEPS] [RESYNC] \
        [key=value ...]

RESYNC=1 restarts the port from the JAX state before every step, so each
line measures one step's formulas alone; RESYNC=0 (the default) lets the
two runs go on from their own states. Extra overrides follow the
record's (the default adds precision=float64 dynamics.nchains=8). Run
from the repository root; a 64x64 step takes ~1.5 s here.
"""
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from l2hmc_torch.configs import get_config as tget_config  # noqa: E402
from l2hmc_torch.records.quality import U1_64X64_BF16  # noqa: E402
from l2hmc_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from l2hmc_tpu.configs import get_config  # noqa: E402
from l2hmc_tpu.train.trainer import Trainer  # noqa: E402
from test_torch_trainer import _adam_state, _pairs  # noqa: E402
from torch_parity import fb_draws, params_to_numpy, to_torch  # noqa: E402


def resync(ttr, ts, x):
    """The JAX state in the port: weights, masks, BN statistics, Adam."""
    ttr.dynamics.load_jax_params(params_to_numpy(ts.params),
                                 np.asarray(ts.masks))
    adam = _adam_state(ts.opt_state)
    mu = {n: j for n, _, j in _pairs(ttr.dynamics, adam.mu)}
    nu = {n: j for n, _, j in _pairs(ttr.dynamics, adam.nu)}
    for name, t, _ in _pairs(ttr.dynamics, ts.params):
        if isinstance(t, torch.nn.Parameter) and t in ttr.optimizer.state:
            st = ttr.optimizer.state[t]
            st["exp_avg"].copy_(torch.from_numpy(np.array(mu[name])))
            st["exp_avg_sq"].copy_(torch.from_numpy(np.array(nu[name])))
    return to_torch(x)


def main(argv) -> int:
    nsteps = int(argv[0]) if argv else 200
    every = int(argv[1]) if len(argv) > 1 else 0
    overrides = [t for t in U1_64X64_BF16
                 if not t.startswith(("precision=", "dynamics.nchains="))]
    overrides += ["precision=float64", "dynamics.nchains=8", *argv[2:]]
    print("overrides", overrides, flush=True)
    jtr = Trainer(get_config(overrides))
    ts, x = jtr.init_state(jax.random.PRNGKey(0))
    ttr = TTrainer(tget_config(overrides), device="cpu")
    tx = resync(ttr, ts, x)
    beta = float(ttr.schedule.beta_final)
    print("step rel_dloss rel_dgnorm max_dparam max_dx acc_jax acc_port "
          "flips", flush=True)
    t0 = time.time()
    for step in range(nsteps):
        key = jax.random.PRNGKey(1000 + step)
        draws = fb_draws(jtr.dynamics, x, jax.random.split(key, 3)[0],
                         training=True)
        ts, x, jm = jtr.train_step(ts, x, beta, key)
        tx, tm = ttr.train_step(tx, beta, draws=draws)
        jl, jg = float(jm["loss"]), float(jm["grad_norm"])
        dl = abs(float(tm["loss"]) - jl) / max(abs(jl), 1e-300)
        dg = abs(float(tm["grad_norm"]) - jg) / max(jg, 1e-300)
        dp = max(float(np.max(np.abs(t.detach().numpy() - j)))
                 for _, t, j in _pairs(ttr.dynamics, ts.params))
        d = np.abs(tx.numpy() - np.asarray(x)) % (2 * np.pi)
        dx = float(np.max(np.minimum(d, 2 * np.pi - d)))
        ja, ta = np.asarray(jm["acc_mask"]), tm["acc_mask"].numpy()
        flips = ja != ta
        print(f"{step} {dl:.3e} {dg:.3e} {dp:.3e} {dx:.3e} "
              f"{float(np.mean(jm['acc'])):.3f} {float(tm['acc'].mean()):.3f}"
              f" {int(flips.sum())} grad_nonfinite="
              f"{int(jm['grad_nonfinite'])},{int(tm['grad_nonfinite'])}",
              flush=True)
        if flips.any():
            print(f"  decisions differ: u {np.asarray(draws['u'])[flips]}, "
                  f"acc {np.asarray(jm['acc'])[flips]} (JAX), "
                  f"{tm['acc'].numpy()[flips]} (port); restarting the port "
                  "from the JAX state", flush=True)
            tx = resync(ttr, ts, x)
        elif every and (step + 1) % every == 0:
            tx = resync(ttr, ts, x)
    print(f"{nsteps} steps in {time.time() - t0:.0f} s")
    return 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    raise SystemExit(main(sys.argv[1:]))
