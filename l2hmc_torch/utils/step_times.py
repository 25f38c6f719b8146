"""Train, eval and HMC step times of the default U(1) configuration on one
CUDA card.

    python -m l2hmc_torch.utils.step_times [--rounds N]

Prints one JSON line: the card, the package that was timed, and for each
step kind the host-clock milliseconds per step (each round is the mean of
a few steps that end in a synchronise; the line gives every round and
their median). The steps are host-launch bound, so their times move with
whatever else the host's cores are doing: compare two checkouts only by
running them in turns inside one call on one card.

The script uses nothing but the package's public entry points, so it can
time another checkout's package too: run this file with that checkout
first on PYTHONPATH, e.g.

    PYTHONPATH=/path/to/other python l2hmc_torch/utils/step_times.py
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time

import torch

#: steps per round
STEPS = {"train": 5, "eval": 20, "hmc": 50}


def round_ms(fn, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_times: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import l2hmc_torch
    from l2hmc_torch.experiment import build_experiment
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="l2hmc_torch_steps_") as out:
        ex = build_experiment(["steps.nera=1", "steps.nepoch=3",
                               "steps.test=3", "save=false",
                               f"outdir={out}"], device="cuda")
        ex.run()                      # builds the kernels, warms every path
    cfg, tr = ex.cfg, ex.trainer
    x = ex._x.contiguous()
    xe = x[: max(2, cfg.dynamics.nchains // 4)].contiguous()
    beta = float(cfg.annealing_schedule.beta_final)
    eps = cfg.dynamics.eps_hmc
    steps = {
        "train": lambda: tr.train_step(x, beta, ex.generator),
        "eval": lambda: tr.eval_step(xe, beta, ex.generator),
        "hmc": lambda: tr.hmc_step(xe, beta, eps, ex.generator),
    }
    rounds = {job: [round_ms(fn, STEPS[job]) for _ in range(args.rounds)]
              for job, fn in steps.items()}
    print(json.dumps({
        "card": card, "package": l2hmc_torch.__path__[0],
        "nchains": {"train": int(x.shape[0]), "eval": int(xe.shape[0]),
                    "hmc": int(xe.shape[0])},
        "median_ms": {job: statistics.median(r) for job, r in rounds.items()},
        "rounds_ms": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
