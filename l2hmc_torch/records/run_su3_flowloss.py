"""SU(3) 8^4 beta=5.7 training run with the Wilson-FLOWED charge loss.

The port's counterpart of the JAX package's `records/run_su3_flowloss.py`:
the configuration of the committed 8^4 record (`su3_8x8_b57_quality.md`)
with the charge loss taken on the differentiably Wilson-flowed clover
charge (12 RK steps of 0.1), trained, evaluated, and compared with the
matched-cost HMC baseline of that record (same volume, beta, eps,
leapfrog evaluations and draws), read from `--baseline`.

    python -m l2hmc_torch.records.run_su3_flowloss [outdir] [nera] \
        [nepoch] [warmup] [test] [--baseline PATH] [--commit SHA] \
        [device=cpu] [key=value ...]

Extra `key=value` arguments follow OVERRIDES (the last one wins). It writes
`train_partial.json` (the training series, as soon as training ends) and
`summary.json` under `outdir`, and nothing elsewhere.
"""
from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional, Sequence

import numpy as np

from l2hmc_torch.records import quality as q

#: the JAX driver's overrides (records/run_su3_flowloss.py) for the
#: default nera/nepoch/warmup/test, outdir aside
OVERRIDES = [
    "dynamics.latvolume=[8, 8, 8, 8]", "dynamics.nchains=8",
    "nchains=8", "dynamics.nleapfrog=4", "dynamics.eps=0.02",
    "dynamics.eps_hmc=0.02", "dynamics.cold_start=true",
    "network.units=[32, 32]", "network.zero_init_heads=true",
    "network.use_batch_norm=false", "network.dropout_prob=0.0",
    "learning_rate.lr_init=1e-4", "learning_rate.clip_norm=1.0",
    "annealing_schedule.beta_init=5.2",
    "annealing_schedule.beta_final=5.7",
    "steps.nera=4", "steps.nepoch=150",
    "steps.test=2000", "steps.warmup=1000",
    "flow_nsteps=12", "flow_eps=0.1",
    "precision=float32", "save=false",
    "loss.use_mixed_loss=true", "loss.charge_weight=0.01",
    "loss.charge_flow_nsteps=12", "loss.charge_flow_eps=0.1",
]

#: the committed 8^4 record whose hmc_stats are the baseline
DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "records", "su3_8x8_b57_quality_summary.json")


def overrides_for(nera, nepoch, warmup, test) -> list[str]:
    """OVERRIDES with the four positional step counts put in."""
    steps = {"steps.nera": nera, "steps.nepoch": nepoch,
             "steps.warmup": warmup, "steps.test": test}
    out = []
    for ov in OVERRIDES:
        key = ov.split("=", 1)[0]
        out.append(f"{key}={int(steps[key])}" if key in steps else ov)
    return out


def main(outdir: str = "outputs/su3_flowloss", nera="4", nepoch="150",
         warmup="1000", test="2000", baseline: Optional[str] = None,
         extra: Sequence[str] = (), device=None,
         commit: Optional[str] = None) -> dict:
    from l2hmc_torch.experiment import build_experiment
    ex = build_experiment(
        [*overrides_for(nera, nepoch, warmup, test), *extra,
         f"outdir={outdir}"], group="SU3", device=device)

    ex.train()
    # the training series survive a failure in eval
    ht = ex.trainer.histories["train"].get_dataset()
    partial = {k: np.asarray(ht[k]).ravel().tolist()
               for k in ("loss", "grad_norm", "grad_nonfinite", "acc",
                         "plaqs") if k in ht}
    q.write_json(os.path.join(outdir, "train_partial.json"), partial)

    ex.evaluate("eval")
    eval_stats = ex.sampler_stats("eval")
    eval_se = q.chain_se(ex.trainer.histories["eval"])

    # matched-cost HMC baseline of the committed record (8 chains x 2000
    # draws, eps 0.02, 8 leapfrog evaluations a draw, 12 x 0.1 flow)
    with open(baseline or DEFAULT_BASELINE) as f:
        base = json.load(f)
    hmc_stats = base["hmc_stats"]
    he = ex.trainer.histories["eval"].get_dataset()
    improvement = float(np.mean(he["dQint"])) / max(hmc_stats["dQint"],
                                                    1e-16)

    out = {
        "improvement_vs_committed_hmc": improvement,
        "dQint_flow_ratio": eval_stats.get("dQint_flow", float("nan"))
        / max(hmc_stats["dQint_flow"], 1e-16),
        "flowQ_tau_ratio_hmc_over_trained":
            hmc_stats["flowQ_tau_int"]
            / max(eval_stats.get("flowQ_tau_int", float("nan")), 1e-16),
        "train": ex.trainer.timers["train"].get_eval_rate(),
        "eval": ex.trainer.timers["eval"].get_eval_rate(),
        "eval_stats": eval_stats,
        "hmc_stats_committed_baseline": hmc_stats,
        "unflowed_loss_eval_stats_committed": base["eval_stats"],
        "loss": {"charge_weight": 0.01, "charge_flow_nsteps": 12,
                 "charge_flow_eps": 0.1, "use_mixed_loss": True},
        "protocol": {"nera": int(nera), "nepoch": int(nepoch),
                     "warmup": int(warmup), "eval_steps": int(test)},
        "se": {"eval_stats": eval_se},
        "device": q.device_line(ex.device),
        "commit": q.commit_id(commit),
    }
    q.write_json(os.path.join(outdir, "summary.json"), out)
    print(json.dumps(out, indent=1, default=float))
    return out


def cli(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    pos, ovs, opts = q.split_args(sys.argv[1:] if argv is None else argv)
    main(*pos, baseline=opts.get("baseline"), extra=ovs,
         device=opts.get("device"), commit=opts.get("commit"))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
