"""Standalone 4D SU(3) script: HMC -> eval -> train with unitarity checks.

PyTorch counterpart of the JAX package's `train4dsu3.py` (after the
reference's `train4dSU3.py`, src/l2hmc/train4dSU3.py:196-303): a scripted
sequence of (1) HMC steps, (2) eval steps with the untrained sampler,
(3) train steps at fixed beta, with `checkSU` unitarity monitors after each
phase.

Run:  python -m l2hmc_torch.train4dsu3 [device=cpu] [key=value overrides]

It runs on the CUDA card unless device=cpu is given, at the precision of
the SU(3) defaults (float64, i.e. complex128 links) unless overridden.
"""
from __future__ import annotations

import logging
import math
import sys

import torch

log = logging.getLogger(__name__)


def check_su(tag: str, x) -> tuple[float, float]:
    """Largest per-chain (mean, max) deviation from SU(3) over the batch."""
    from l2hmc_torch.ops import su3 as g
    a, b = g.checkSU(x.reshape(x.shape[0], -1, 3, 3))
    amax, bmax = float(a.max()), float(b.max())
    log.info(f"checkSU[{tag}]: mean={amax:.3e} max={bmax:.3e}")
    return amax, bmax


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    argv = list(argv if argv is not None else sys.argv[1:])
    device = None
    for a in argv:
        if a.startswith("device="):
            device = a.split("=", 1)[1]
    overrides = [
        "dynamics.nchains=8",
        "dynamics.latvolume=[4, 4, 4, 4]",
        "dynamics.nleapfrog=2",
        "dynamics.eps=0.01",
        "steps.nera=1", "steps.nepoch=50", "steps.test=10", "steps.log=1",
        "annealing_schedule.beta_init=6.0",
        "annealing_schedule.beta_final=6.0",
    ] + [a for a in argv if not a.startswith("device=")]

    from l2hmc_torch.configs import get_config
    from l2hmc_torch.train.trainer import Trainer

    cfg = get_config(overrides, group="SU3")
    trainer = Trainer(cfg, device=device)
    gen = torch.Generator(trainer.device).manual_seed(int(cfg.seed))
    x = trainer.dynamics.random_x(gen)
    beta = cfg.annealing_schedule.beta_init

    # phase 1: HMC (train4dSU3.py: 10 hmc steps, eps=0.1)
    for step in range(10):
        x, m = trainer.hmc_step(x, beta, 0.1, gen)
        log.info(f"hmc step {step}: acc={float(m['acc'].mean()):.3f} "
                 f"plaqs={float(m['plaqs'].mean()):.4f}")
    check_su("post-hmc", x)

    # phase 2: eval with the (untrained) sampler
    for step in range(10):
        x, m = trainer.eval_step(x, beta, gen)
        log.info(f"eval step {step}: acc={float(m['acc'].mean()):.3f}")
    check_su("post-eval", x)

    # phase 3: training
    for step in range(cfg.steps.nepoch):
        x, m = trainer.train_step(x, beta, gen)
        if step % 10 == 0:
            log.info(f"train step {step}: loss={float(m['loss']):.4f} "
                     f"acc={float(m['acc'].mean()):.3f}")
    _, bmax = check_su("post-train", x)
    if not math.isfinite(bmax):
        raise RuntimeError(f"checkSU after training is not finite: {bmax}")
    log.info("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
