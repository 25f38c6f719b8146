"""Train, eval and HMC step times of the default U(1) configuration on one
CUDA card.

    python -m l2hmc_torch.utils.step_times [--rounds N]

Prints one JSON line: the card, the package that was timed, and for each
step kind the host-clock milliseconds per step (each round is the mean of
a few steps that end in a synchronise; the line gives every round and
their median), for the steps as the Trainer takes them on the card
(`graphed`: replayed from CUDA graphs, where the checkout has them) and
for an eager twin of the same state (`eager`, `Trainer.twin`), in turns
within each round; then each graph's capture and instantiation seconds
and the memory its capture added to the graphs' pool. Eager steps are
host-launch bound, so their times move with whatever else the host's
cores are doing: compare two checkouts only by running them in turns
inside one call on one card.

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
    trainers = {"graphed": tr}
    if hasattr(tr, "twin"):
        trainers["eager"] = tr.twin(graphs=False)

    def steps(t):
        return {
            "train": lambda: t.train_step(x, beta, ex.generator),
            "eval": lambda: t.eval_step(xe, beta, ex.generator),
            "hmc": lambda: t.hmc_step(xe, beta, eps, ex.generator),
        }
    fns = {name: steps(t) for name, t in trainers.items()}
    for f in fns.values():       # the graphs of these shapes, captured
        for fn in f.values():
            fn()
            fn()
    rounds = {name: {job: [] for job in STEPS} for name in trainers}
    for _ in range(args.rounds):
        for name, f in fns.items():
            for job, fn in f.items():
                rounds[name][job].append(round_ms(fn, STEPS[job]))
    print(json.dumps({
        "card": card, "package": l2hmc_torch.__path__[0],
        "nchains": {"train": int(x.shape[0]), "eval": int(xe.shape[0]),
                    "hmc": int(xe.shape[0])},
        "median_ms": {name: {job: statistics.median(r) for job, r in
                             rr.items()} for name, rr in rounds.items()},
        "rounds_ms": rounds,
        "graphs": tr.graph_stats() if hasattr(tr, "graph_stats") else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
