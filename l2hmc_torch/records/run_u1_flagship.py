"""U(1) 16x16 flagship quality run with all three HMC-baseline protocols.

The port's counterpart of the JAX package's `records/run_u1_flagship.py`:
the same configuration (2048 chains, nleapfrog 4 merged, eps 0.05, beta 4,
5000 train steps, then 512 chains x 2000 draws), trained once, evaluated
once, and held against plain HMC under three protocols:
  reference  `ex.run()`: fixed eps_hmc = 1/(2*nleapfrog) under merged
             directions (configs.py), trajectory length 1;
  tuned      dynamic_step_size=True, eps adapted toward ~0.65 acceptance;
  literal    eps = 1/nleapfrog of the config over 2*nleapfrog steps
             (trajectory length 2), fixed.

    python -m l2hmc_torch.records.run_u1_flagship [outdir] \
        [--summary PATH] [--commit SHA] [device=cpu] [key=value ...]

Extra `key=value` arguments follow OVERRIDES (the last one wins), for a
tiny run on the CPU. The summary (default `<outdir>/summary.json`) has the
key tree of the JAX record plus `se` (standard errors across chains, see
`quality.chain_se`), `device` and `commit`; the driver writes nothing
outside `outdir` and `--summary`.
"""
from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional, Sequence

from l2hmc_torch.records import quality as q

#: the JAX driver's overrides (records/run_u1_flagship.py), outdir aside
OVERRIDES = [
    "dynamics.nchains=2048", "dynamics.latvolume=[16, 16]",
    "dynamics.nleapfrog=4", "dynamics.eps=0.05",
    "dynamics.merge_directions=true",
    "steps.nera=1", "steps.nepoch=5000", "steps.test=2000",
    "annealing_schedule.beta_init=4.0",
    "annealing_schedule.beta_final=4.0",
    "nchains=512", "precision=float32", "save=false",
]

PROTOCOLS = {
    "hmc_reference_protocol": "reference: fixed eps_hmc = 1/nleapfrog "
                              "(reference configs.py:485-487)",
    "hmc_tuned_baseline": "tuned: dynamic_step_size=True (eps adapted to "
                          "~0.65 acceptance)",
}


def _reset_hmc(ex) -> None:
    from l2hmc_torch.utils.history import History
    ex.trainer.histories["hmc"] = History()
    ex.trainer.timers["hmc"].data = []


def _protocol(ex, improvement: float, eval_stats: dict, eval_se: dict,
              text: str) -> tuple[dict, dict]:
    stats = ex.sampler_stats("hmc")
    se = q.chain_se(ex.trainer.histories["hmc"])
    se_out = {"hmc_stats": se, "improvement": q.improvement_se(
        improvement, eval_stats, eval_se, stats, se)}
    return ({"improvement": improvement, "hmc_stats": stats,
             "protocol": text}, se_out)


def main(outdir: str = "outputs/u1_flagship",
         summary_path: Optional[str] = None, extra: Sequence[str] = (),
         device=None, commit: Optional[str] = None) -> dict:
    from l2hmc_torch.experiment import build_experiment
    ex = build_experiment([*OVERRIDES, *extra, f"outdir={outdir}"],
                          group="U1", device=device)

    # reference protocol end to end: eps_hmc fixed
    summary = ex.run()
    eval_stats = summary["eval_stats"]
    eval_se = q.chain_se(ex.trainer.histories["eval"])
    ref, ref_se = _protocol(ex, summary["improvement"], eval_stats, eval_se,
                            PROTOCOLS["hmc_reference_protocol"])

    # tuned baseline: HMC whose step size self-tunes to ~0.65 acceptance
    _reset_hmc(ex)
    ex.evaluate("hmc", dynamic_step_size=True)
    tuned, tuned_se = _protocol(ex, ex.measure_improvement(), eval_stats,
                                eval_se, PROTOCOLS["hmc_tuned_baseline"])

    # literal reference protocol: eps = 1/nleapfrog of the config, over
    # the 2*nleapfrog steps of merged directions (trajectory length 2)
    nlf_cfg = int(ex.cfg.dynamics.nleapfrog)
    _reset_hmc(ex)
    ex.trainer.evaluate(ex.generator, job_type="hmc", x=ex.setup(),
                        eps=1.0 / nlf_cfg, dynamic_step_size=False)
    literal, literal_se = _protocol(
        ex, ex.measure_improvement(), eval_stats, eval_se,
        f"reference-literal: eps_hmc = 1/nleapfrog_config = {1.0 / nlf_cfg}"
        " over 2*nleapfrog steps (trajectory length 2.0 — the protocol "
        "behind the reference's published acc~0.05 HMC rows)")

    dyn = ex.cfg.dynamics
    out = {
        "eval_stats": eval_stats,
        "train": summary["train"],
        "eval": summary["eval"],
        "hmc_reference_protocol": ref,
        "hmc_tuned_baseline": tuned,
        "hmc_reference_literal": literal,
        "config": {
            "nchains_train": int(dyn.nchains),
            "nchains_eval": int(ex.cfg.nchains),
            "latvolume": list(dyn.latvolume),
            "nleapfrog": int(dyn.nleapfrog), "eps": float(dyn.eps),
            "beta": float(ex.cfg.annealing_schedule.beta_final),
            "train_steps": int(ex.cfg.steps.nera * ex.cfg.steps.nepoch),
            "eval_steps": int(ex.cfg.steps.test),
        },
        "se": {"eval_stats": eval_se,
               "hmc_reference_protocol": ref_se,
               "hmc_tuned_baseline": tuned_se,
               "hmc_reference_literal": literal_se},
        "device": q.device_line(ex.device),
        "commit": q.commit_id(commit),
    }
    path = summary_path or os.path.join(outdir, "summary.json")
    q.write_json(path, out)
    print(json.dumps({k: out[k] for k in
                      ("eval_stats", "hmc_reference_protocol",
                       "hmc_tuned_baseline", "hmc_reference_literal", "se",
                       "device")}, indent=1, default=float))
    print("wrote", path)
    return out


def cli(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s] %(message)s")
    pos, ovs, opts = q.split_args(sys.argv[1:] if argv is None else argv)
    main(pos[0] if pos else "outputs/u1_flagship", opts.get("summary"),
         ovs, device=opts.get("device"), commit=opts.get("commit"))
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
