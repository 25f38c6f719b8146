"""Run-to-run spread of the U(1) flagship's two HMC baselines.

Plain HMC involves no training, so the flagship's reference protocol
(fixed eps_hmc) and tuned protocol (dynamic_step_size) can be repeated
cheaply: here each runs `seeds` times, every run from the same thermalised
configuration under its own generator seed, at the flagship's
configuration (`run_u1_flagship.OVERRIDES`: 512 chains x 2000 draws, beta
4). For acc and dQint it reports the mean and the standard deviation over
runs beside two standard errors of a single run:
  se_chains  std of the per-chain means / sqrt(nchains), the summaries'
             `se` (`quality.chain_se`); right when the chains are
             independent;
  se_draws   std of the means of blocks of `block` draws (the mean over
             chains first) / sqrt(nblocks); it also sees what all chains
             share, such as the one step size the tuned protocol adapts
             from their mean acceptance.

    python -m l2hmc_torch.records.hmc_spread [outdir] [--seeds N] \
        [--therm N] [--block N] [device=cpu] [key=value ...]

writes `<outdir>/hmc_spread.json`.
"""
from __future__ import annotations

import json
import logging
import math
import os
import sys
from typing import Sequence

import numpy as np
import torch

from l2hmc_torch.records import quality as q
from l2hmc_torch.records.run_u1_flagship import OVERRIDES

PROTOCOLS = {"hmc_reference_protocol": False, "hmc_tuned_baseline": True}
KEYS = ("acc", "dQint")


def draws_se(history, block: int) -> dict:
    """Batch-means standard error over draws of each of KEYS."""
    h = history.get_dataset()
    out = {}
    for k in KEYS:
        series = np.asarray(h[k], dtype=np.float64).mean(axis=0)
        nblocks = series.size // block
        if nblocks < 2:
            out[k] = float("nan")
            continue
        means = series[: nblocks * block].reshape(nblocks, block).mean(1)
        out[k] = float(np.std(means, ddof=1) / math.sqrt(nblocks))
    return out


def main(outdir: str = "outputs/hmc_spread", seeds: int = 8,
         therm: int = 500, block: int = 100, extra: Sequence[str] = (),
         device=None) -> dict:
    from l2hmc_torch.configs import get_config
    from l2hmc_torch.train.trainer import Trainer
    from l2hmc_torch.utils.history import History
    cfg = get_config([*OVERRIDES, *extra], group="U1")
    tr = Trainer(cfg, device=device)
    beta = float(cfg.annealing_schedule.beta_final)
    gen = torch.Generator(tr.device).manual_seed(int(cfg.seed))
    x = tr.random_x(gen, int(cfg.nchains))
    with torch.no_grad():
        for _ in range(therm):
            x, _ = tr.hmc_step(x, beta, cfg.dynamics.eps_hmc, gen)
    runs = {p: [] for p in PROTOCOLS}
    for seed in range(seeds):
        for name, dynamic in PROTOCOLS.items():
            tr.histories["hmc"] = History()
            g = torch.Generator(tr.device).manual_seed(1000 + seed)
            tr.evaluate(g, job_type="hmc", x=x, dynamic_step_size=dynamic)
            h = tr.histories["hmc"]
            ds = h.get_dataset()
            runs[name].append({
                "seed": 1000 + seed,
                **{k: float(np.mean(ds[k])) for k in KEYS},
                "se_chains": {k: v for k, v in q.chain_se(h).items()
                              if k in KEYS},
                "se_draws": draws_se(h, block)})
    spread = {}
    for name, rs in runs.items():
        spread[name] = {}
        for k in KEYS:
            vals = np.array([r[k] for r in rs])
            spread[name][k] = {
                "mean": float(vals.mean()),
                "std_over_runs": (float(vals.std(ddof=1)) if len(rs) > 1
                                  else float("nan")),
                "se_chains": float(np.mean([r["se_chains"][k] for r in rs])),
                "se_draws": float(np.mean([r["se_draws"][k] for r in rs]))}
    out = {"spread": spread, "runs": runs,
           "config": {"nchains": int(cfg.nchains),
                      "draws": int(cfg.steps.test), "beta": beta,
                      "eps_hmc": float(cfg.dynamics.eps_hmc),
                      "seeds": seeds, "therm": therm, "block": block},
           "device": q.device_line(tr.device)}
    q.write_json(os.path.join(outdir, "hmc_spread.json"), out)
    print(json.dumps({"spread": spread, "device": out["device"]}, indent=1))
    return out


def cli(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s] %(message)s")
    pos, ovs, opts = q.split_args(sys.argv[1:] if argv is None else argv)
    main(pos[0] if pos else "outputs/hmc_spread",
         int(opts.get("seeds", 8)), int(opts.get("therm", 500)),
         int(opts.get("block", 100)), ovs, device=opts.get("device"))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
