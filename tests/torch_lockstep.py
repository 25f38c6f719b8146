"""Train steps of the JAX package and the port in lockstep, at a quality
record's knobs in float64 on the CPU: the same start, weights and injected
draws, one line per step with |loss difference| / |loss|, |grad_norm
difference| / grad_norm, the largest parameter difference, the largest x
difference, the largest sumlogdet difference, both mean acceptances and
the chains whose Metropolis-Hastings decision differs. A step where the
decisions differ restarts the port from the JAX state (weights, BN
statistics, Adam moments, x).

    JAX_PLATFORMS=cpu python tests/torch_lockstep.py [RECORD] [NSTEPS] \
        [RESYNC] [key=value ...] [--warmup N]

RECORD is `u1_64x64_bf16` (the default: `quality.U1_64X64_BF16`, 8
chains; x compared as angles mod 2 pi; ~1.5 s a step here) or
`su3_8x8_b57` (`quality.SU3_8X8_B57` cut to a 2^4 lattice and 8 chains:
cold start, zero-init heads, the mixed loss, clip 1.0, trained at the
first era's beta 5.2; x compared as complex link matrices; the JAX step
is compiled once, ~3 min, then a step takes ~0.3 s on the JAX side and
~1 s on the port's). Both run in float64. RESYNC=1 restarts the port from
the JAX state before every step, so each line measures one step's
formulas alone; RESYNC=0 (the default) lets the two runs go on from their
own states. `moved` is the largest change of any parameter since the
start on each side: with `learning_rate.lr_init=0` both stay at 0. Extra
overrides follow the record's. Run from the repository root.

`--warmup N` first runs the trainers' HMC warmup for N trajectories in
lockstep from the same start (injected momenta and MH uniforms; the step
size self-tuned every 10 trajectories from the JAX acceptance, as both
warmups tune it), one line every 10 with both mean acceptances and
plaquettes, the largest x difference and the step size; the port is
restarted from the JAX x wherever a decision differs, and the train steps
start from the warmed x.
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
from l2hmc_torch.records.quality import (SU3_8X8_B57,  # noqa: E402
                                         U1_64X64_BF16)
from l2hmc_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from l2hmc_tpu.configs import get_config  # noqa: E402
from l2hmc_tpu.train.trainer import Trainer  # noqa: E402
from test_torch_trainer import _adam_state  # noqa: E402
from torch_parity import (fb_draws, grad_pairs,  # noqa: E402
                          hmc_draws, params_to_numpy, to_torch)

#: record -> (its overrides, the tokens the lockstep replaces, its own)
RECORDS = {
    "u1_64x64_bf16": (U1_64X64_BF16, ("precision=", "dynamics.nchains="),
                      ["precision=float64", "dynamics.nchains=8"]),
    "su3_8x8_b57": (SU3_8X8_B57, ("precision=", "dynamics.nchains=",
                                  "dynamics.latvolume="),
                    ["precision=float64", "dynamics.nchains=8",
                     "dynamics.latvolume=[2,2,2,2]"]),
}


def pairs(ttr, tree):
    """(name, port tensor, JAX array in the torch layout) for every
    parameter (and BN buffer where the nets have BN)."""
    if ttr.cfg.dynamics.group == "U1":
        from test_torch_trainer import _pairs
        yield from _pairs(ttr.dynamics, tree)
    else:
        yield from grad_pairs(ttr.dynamics, tree, None)


def resync(ttr, ts, x):
    """The JAX state in the port: weights, masks, BN statistics, Adam."""
    ttr.dynamics.load_jax_params(params_to_numpy(ts.params),
                                 np.asarray(ts.masks))
    adam = _adam_state(ts.opt_state)
    mu = {n: j for n, _, j in pairs(ttr, adam.mu)}
    nu = {n: j for n, _, j in pairs(ttr, adam.nu)}
    for name, t, _ in pairs(ttr, ts.params):
        if isinstance(t, torch.nn.Parameter) and t in ttr.optimizer.state:
            st = ttr.optimizer.state[t]
            st["exp_avg"].copy_(torch.from_numpy(np.array(mu[name])))
            st["exp_avg_sq"].copy_(torch.from_numpy(np.array(nu[name])))
    return to_torch(x)


def x_diff(tx, x, group: str) -> float:
    if group == "U1":
        d = np.abs(tx.numpy() - np.asarray(x)) % (2 * np.pi)
        return float(np.max(np.minimum(d, 2 * np.pi - d)))
    return float(np.max(np.abs(tx.numpy() - np.asarray(x))))


def unitarity(x: np.ndarray) -> float:
    """max |x^dag x - 1| over the links of an SU(3) field (nan for U(1))."""
    if not np.iscomplexobj(x):
        return float("nan")
    u = x.reshape(-1, 3, 3)
    return float(np.max(np.abs(np.conj(np.swapaxes(u, -1, -2)) @ u
                               - np.eye(3))))


def warmup(jtr, ttr, x, beta: float, nsteps: int):
    """Both trainers' HMC warmup in lockstep from the JAX x; returns the
    JAX x after it."""
    eps = float(jtr.cfg.dynamics.eps_hmc)
    tx = to_torch(x)
    print("warmup: step acc_jax acc_port plaq_jax plaq_port max_dx flips "
          "eps unitarity_jax,port", flush=True)
    for step in range(nsteps):
        key = jax.random.PRNGKey(500_000 + step)
        draws = hmc_draws(jtr.dynamics, x, key)
        x, jm = jtr.hmc_step(x, beta, key, eps)
        tx, tm = ttr.hmc_step(tx, beta, eps, draws=draws)
        flips = np.asarray(jm["acc_mask"]) != tm["acc_mask"].numpy()
        if (step + 1) % 10 == 0 or flips.any():
            print(f"  {step} {float(np.mean(jm['acc'])):.4f} "
                  f"{float(tm['acc'].mean()):.4f} "
                  f"{float(np.mean(jm['plaqs'])):.6f} "
                  f"{float(tm['plaqs'].mean()):.6f} "
                  f"{x_diff(tx, x, ttr.cfg.dynamics.group):.3e} "
                  f"{int(flips.sum())} {eps:.4g} "
                  f"{unitarity(np.asarray(x)):.3e},"
                  f"{unitarity(tx.numpy()):.3e}", flush=True)
        if flips.any():
            tx = to_torch(x)
        if (step + 1) % 10 == 0:
            a = float(np.mean(jm["acc"]))
            if a > 0.75:
                eps = min(eps * 1.2, 0.5)
            elif a < 0.5:
                eps = max(eps / 1.5, 1e-5)
    return x


def main(argv) -> int:
    nwarm = 0
    if "--warmup" in argv:
        i = argv.index("--warmup")
        nwarm = int(argv[i + 1])
        del argv[i:i + 2]
    name = argv.pop(0) if argv and argv[0] in RECORDS else "u1_64x64_bf16"
    nsteps = int(argv[0]) if argv else 200
    every = int(argv[1]) if len(argv) > 1 else 0
    record, replaced, own = RECORDS[name]
    overrides = [t for t in record if not t.startswith(replaced)]
    overrides += [*own, *argv[2:]]
    print("overrides", overrides, flush=True)
    group = record[0].split("=", 1)[1]
    jtr = Trainer(get_config(overrides, group=group))
    ts, x = jtr.init_state(jax.random.PRNGKey(0))
    ttr = TTrainer(tget_config(overrides, group=group), device="cpu")
    beta = float(ttr.cfg.annealing_schedule.beta_init)
    print(f"group {group}, beta {beta}", flush=True)
    if nwarm:
        x = warmup(jtr, ttr, x, beta, nwarm)
    tx = resync(ttr, ts, x)
    start = {n: j.copy() for n, _, j in pairs(ttr, ts.params)}
    print("step rel_dloss rel_dgnorm max_dparam max_dx max_dsumlogdet "
          "acc_jax acc_port flips grad_norm_jax moved_jax,port", flush=True)
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
        now = list(pairs(ttr, ts.params))
        dp = max(float(np.max(np.abs(t.detach().numpy() - j)))
                 for _, t, j in now)
        moved_j = max(float(np.max(np.abs(j - start[n]))) for n, _, j in now)
        moved_t = max(float(np.max(np.abs(t.detach().numpy() - start[n])))
                      for n, t, _ in now)
        dx = x_diff(tx, x, group)
        dsld = float(np.max(np.abs(tm["sumlogdet"].numpy()
                                   - np.asarray(jm["sumlogdet"]))))
        ja, ta = np.asarray(jm["acc_mask"]), tm["acc_mask"].numpy()
        flips = ja != ta
        print(f"{step} {dl:.3e} {dg:.3e} {dp:.3e} {dx:.3e} {dsld:.3e} "
              f"{float(np.mean(jm['acc'])):.3f} {float(tm['acc'].mean()):.3f}"
              f" {int(flips.sum())} {jg:.4e} {moved_j:.3e},{moved_t:.3e}"
              f" grad_nonfinite={int(jm['grad_nonfinite'])},"
              f"{int(tm['grad_nonfinite'])}", flush=True)
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
