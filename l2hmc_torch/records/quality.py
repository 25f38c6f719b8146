"""Quality records of the port: the two companion records of the U(1)
flagship, the SU(3) 8^4 beta 5.7 topology record, and what every record
driver shares.

    python -m l2hmc_torch.records.quality \
        {u1_64x64_bf16|su3_4x4_b6|su3_8x8_b57|su3_4x4_b6_frozen|
         su3_8x8_b57_frozen} \
        [outdir] [device=cpu] [key=value ...] [--commit SHA] [--ref JSON]

runs `build_experiment(RECORDS[name]).run()` (train -> eval -> HMC ->
improvement) and writes `<outdir>/summary.json` with the keys of the JAX
package's record summaries (the flowed-charge sector statistics of the
8^4 record included, `flow_sectors`) plus:
  se      the standard error of acc, dQint and dQsin (and of dQint_flow
          and the sector <Q^2> where the draws were flowed) across chains
          for each `*_stats` entry (std of the per-chain means /
          sqrt(nchains)), and of the improvement (delta method over the
          two chain sets);
  device  the card's name and power limit (nvidia-smi), or "cpu";
  commit  the source's git commit (`--commit`, else `git rev-parse HEAD`).
Beside it, `<outdir>/train_health.json` counts the train steps with a
non-finite gradient entry and gives the range of grad_norm over every
step, logged or not, and `<outdir>/train_curve.json` holds one row per
train step: beta, the chain means of acc, dQint, loss, sumlogdet and the
plaquette, and the means of the step sizes xeps and veps.

`su3_*_frozen` is its record with `learning_rate.lr_init=0`: the networks
stay at their zero init, the gradient is still computed (`SU3_FROZEN`).

A run with `save=true` keeps both beside each era's checkpoint, and one
with `restore=true` picks them up from there, so a record split over
several processes still covers every train step once.

Extra `key=value` arguments follow the record's overrides, so the last
one wins: `device=cpu steps.nepoch=3 ...` gives a tiny run on the CPU.

`compare(port_summary, ref_summary)` puts a port summary beside a record:
for each quality statistic the reference value, the port value, their
difference, and the difference over sqrt(2)*SE_port. It reads only the
`*_stats` entries and the improvements; the timer sections of a record are
not the port's and are never copied.
"""
from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch

#: records/u1_64x64_bf16_quality.md, its command token for token
U1_64X64_BF16 = [
    "group=U1", "precision=bf16",
    "dynamics.nchains=2048", "dynamics.latvolume=[64,64]",
    "dynamics.nleapfrog=4", "dynamics.eps=0.025", "dynamics.eps_hmc=0.025",
    "steps.nera=1", "steps.nepoch=2000", "steps.test=1000", "nchains=512",
    "annealing_schedule.beta_init=4.0", "annealing_schedule.beta_final=4.0",
]

#: records/su3_4x4_b6_quality.md, its command token for token. The JAX
#: record was made by the package of commit 707bd41 (round 3), which
#: predates 85d1431 (see `SU3_FROZEN`)
SU3_4X4_B6 = [
    "group=SU3", "precision=float32",
    "dynamics.latvolume=[4,4,4,4]", "dynamics.nchains=8",
    "dynamics.nleapfrog=4", "dynamics.eps=0.05", "dynamics.eps_hmc=0.05",
    "network.units=[32,32]", "network.use_batch_norm=false",
    "network.dropout_prob=0.0", "network.zero_init_heads=true",
    "loss.use_mixed_loss=true", "learning_rate.lr_init=1e-4",
    "learning_rate.clip_norm=1.0", "steps.nera=4", "steps.nepoch=150",
    "steps.test=150", "annealing_schedule.beta_init=6.0",
    "annealing_schedule.beta_final=6.0",
]

#: records/su3_8x8_b57_quality.md, its command token for token. The JAX
#: record was made by the package of commit 95dc1d5, which predates
#: 85d1431 (see `SU3_FROZEN`)
SU3_8X8_B57 = [
    "group=SU3", "precision=float32",
    "dynamics.latvolume=[8,8,8,8]", "dynamics.nchains=8", "nchains=8",
    "dynamics.nleapfrog=4", "dynamics.eps=0.02", "dynamics.eps_hmc=0.02",
    "dynamics.cold_start=true", "network.units=[32,32]",
    "network.zero_init_heads=true", "network.use_batch_norm=false",
    "network.dropout_prob=0.0", "loss.use_mixed_loss=true",
    "learning_rate.lr_init=1e-4", "learning_rate.clip_norm=1.0",
    "annealing_schedule.beta_init=5.2", "annealing_schedule.beta_final=5.7",
    "steps.nera=4", "steps.nepoch=150", "steps.test=2000",
    "steps.warmup=1000", "flow_nsteps=12", "flow_eps=0.1", "save=false",
]

#: Why the `*_frozen` records exist. Both JAX SU(3) records were made
#: before commit 85d1431 ("Fix silent zero gradient in all SU(3)
#: training"). Until then the x update re-projected each link with
#: `projectSU`, whose eigendecomposition has a NaN backward at x^dag x = I;
#: `nan_to_num` zeroed such a gradient with no count, and a zero gradient
#: leaves Adam's moments and update at 0. 85d1431 put the Newton-Schulz
#: `reunit` in its place and counted `grad_nonfinite`; the port follows it.
#: A record run with lr 0 keeps the networks at their zero init, as a run
#: whose every gradient was zeroed would have: it is that run's like-for-
#: like counterpart.
SU3_FROZEN = ["learning_rate.lr_init=0"]

RECORDS = {"u1_64x64_bf16": U1_64X64_BF16, "su3_4x4_b6": SU3_4X4_B6,
           "su3_8x8_b57": SU3_8X8_B57,
           "su3_4x4_b6_frozen": SU3_4X4_B6 + SU3_FROZEN,
           "su3_8x8_b57_frozen": SU3_8X8_B57 + SU3_FROZEN}

#: per-chain series whose standard error a summary carries
SE_KEYS = ("acc", "dQint", "dQsin")


def _se(means: np.ndarray) -> float:
    """Standard error of the mean over chains of per-chain values."""
    n = means.shape[0]
    return (float(np.std(means, ddof=1) / math.sqrt(n)) if n > 1
            else float("nan"))


def chain_se(history) -> dict:
    """Standard error of each of SE_KEYS across chains: the std of the
    per-chain means over sqrt(nchains). Draws within a chain are
    correlated; the chains are independent, so their means are too."""
    h = history.get_dataset()
    out = {}
    for k in SE_KEYS:
        if k not in h:
            continue
        q = np.atleast_2d(np.asarray(h[k], dtype=np.float64))
        out[k] = _se(q.reshape(q.shape[0], -1).mean(axis=1))
    return out


def flow_sectors(history) -> tuple[dict, dict]:
    """The flowed-charge sector statistics the JAX 8^4 record's summary
    adds to its package's `sampler_stats`: <Q^2> over the integer sectors
    round(flowQ) and the largest |sector| reached; and the SE across
    chains of dQint_flow and of the sector <Q^2>. ({}, {}) without a
    flowed charge."""
    h = history.get_dataset()
    if "flowQ" not in h:
        return {}, {}
    q = np.round(np.atleast_2d(np.asarray(h["flowQ"], dtype=np.float64)))
    q = q.reshape(q.shape[0], -1)
    stats = {"flowQ_sector_Q2": float(np.mean(q * q)),
             "flowQ_max_abs_sector": float(np.max(np.abs(q)))}
    se = {"dQint_flow": _se(np.mean(np.abs(np.diff(q, axis=1)), axis=1)),
          "flowQ_sector_Q2": _se(np.mean(q * q, axis=1))}
    return stats, se


def improvement_se(improvement: float, eval_stats: dict, eval_se: dict,
                   hmc_stats: dict, hmc_se: dict) -> float:
    """SE of mean(dQint_eval) / mean(dQint_hmc) by the delta method; the
    two means come from independent chain sets."""
    re = eval_se.get("dQint", float("nan")) / max(eval_stats["dQint"], 1e-16)
    rh = hmc_se.get("dQint", float("nan")) / max(hmc_stats["dQint"], 1e-16)
    return float(abs(improvement) * math.sqrt(re * re + rh * rh))


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or cpu."""
    import torch
    if torch.device(device).type != "cuda":
        return "cpu"
    from l2hmc_torch.utils.kernel_times import card_line
    return card_line()


def commit_id(given: Optional[str] = None) -> str:
    """The source's commit: as given, else git's HEAD in the checkout
    (with "-dirty" for uncommitted changes), else "unknown"."""
    if given:
        return given
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                              capture_output=True, text=True, check=True,
                              timeout=30).stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain",
                                "--untracked-files=no"], cwd=root,
                               capture_output=True, text=True, check=True,
                               timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return head + ("-dirty" if dirty else "")


def split_args(argv: Sequence[str]) -> tuple[list, list, dict]:
    """Positional arguments, `key=value` overrides and `--flag value`
    options (device=... among the overrides is taken out as an option)."""
    pos, ovs, opts = [], [], {}
    it = iter(argv)
    for a in it:
        if a.startswith("--"):
            k, _, v = a[2:].partition("=")
            opts[k] = v if v else next(it)
        elif a.startswith("device="):
            opts["device"] = a.split("=", 1)[1]
        elif "=" in a:
            ovs.append(a)
        else:
            pos.append(a)
    return pos, ovs, opts


def write_json(path: str, obj: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=float)


def key_tree(d):
    """The nested keys of a summary, leaves as None."""
    if isinstance(d, dict):
        return {k: key_tree(v) for k, v in d.items()}
    return None


def _walk(ref, port, se, path, out):
    for k, rv in ref.items():
        if k not in port:
            continue
        pv, sv = port[k], (se or {}).get(k) if isinstance(se, dict) else None
        p = f"{path}.{k}" if path else k
        if isinstance(rv, dict):
            if k.endswith("_stats") or k.startswith("hmc_"):
                _walk(rv, pv, sv, p, out)
        elif k == "improvement" or path.endswith("_stats"):
            if not isinstance(rv, (int, float)) or isinstance(rv, bool):
                continue
            s = sv if isinstance(sv, (int, float)) else None
            diff = float(pv) - float(rv)
            out[p] = {"ref": float(rv), "port": float(pv), "diff": diff,
                      "se_port": s,
                      "z": (diff / (math.sqrt(2.0) * s)
                            if s and s > 0 and math.isfinite(s) else None)}


def compare(port_summary: dict, ref_summary: dict) -> dict:
    """{path: {ref, port, diff, se_port, z}} for every quality statistic
    both summaries hold: the `*_stats` entries and the improvements, at
    the top level or under an HMC protocol (`hmc_reference_protocol`,
    ...). z = diff / (sqrt(2) * SE_port), None where the port's summary
    gives no SE for that statistic."""
    out: dict = {}
    _walk(ref_summary, port_summary, port_summary.get("se", {}), "", out)
    return out


def add_se(ex, summary: dict) -> dict:
    """The `se` entry of an Experiment.run() summary."""
    tr = ex.trainer
    se = {"eval_stats": chain_se(tr.histories["eval"]),
          "hmc_stats": chain_se(tr.histories["hmc"])}
    se["improvement"] = improvement_se(
        summary["improvement"], summary["eval_stats"], se["eval_stats"],
        summary["hmc_stats"], se["hmc_stats"])
    return se


#: the columns `TrainRecord` keeps per train step
HEALTH_KEYS = ("grad_nonfinite", "grad_norm")
CURVE_KEYS = ("acc", "dQint", "loss", "xeps", "veps", "sumlogdet",
              "plaqs")


class TrainRecord:
    """Every train step's gradient health and training curve, logged or
    not (the history holds every `steps.log`-th step only), kept on the
    device with no host sync: `trainer.train_step` is wrapped to stack
    HEALTH_KEYS and the means of CURVE_KEYS into one row."""

    def __init__(self, trainer):
        self.trainer = trainer
        #: this process' rows, on the device
        self.rows: list = []
        #: the rows an earlier process kept (`load`), on the host
        self.saved = np.zeros((0, len(HEALTH_KEYS + CURVE_KEYS)))
        self.betas: list = []
        plain_step = trainer.train_step

        def train_step(x, beta, *args, **kw):
            xout, m = plain_step(x, beta, *args, **kw)
            self.rows.append(torch.stack(
                [m[k].float().mean() for k in HEALTH_KEYS + CURVE_KEYS]))
            self.betas.append(float(beta))
            return xout, m

        trainer.train_step = train_step

    def array(self) -> np.ndarray:
        if not self.rows:
            return self.saved
        return np.concatenate(
            [self.saved, torch.stack(self.rows).cpu().double().numpy()])

    def save(self, path: str) -> None:
        """The rows and the train step times so far, for a later
        `restore=true` run."""
        torch.save({"rows": self.array(), "betas": list(self.betas),
                    "times": list(self.trainer.timers["train"].data)}, path)

    def load(self, path: str) -> None:
        saved = torch.load(path, weights_only=False)
        self.saved = saved["rows"]
        self.betas = list(saved["betas"])
        self.trainer.timers["train"].data[:0] = saved["times"]

    def health(self) -> dict:
        """Train steps with a non-finite gradient entry, and the range of
        grad_norm."""
        a = self.array()
        nonfinite, norm = a[:, 0], a[:, 1]
        return {"train_steps": int(norm.size),
                "steps_grad_nonfinite": int(np.count_nonzero(nonfinite)),
                "grad_norm_finite_positive": bool(
                    np.all(np.isfinite(norm)) and np.all(norm > 0)),
                "grad_norm_min": float(norm.min()) if norm.size else None,
                "grad_norm_max": float(norm.max()) if norm.size else None}

    def curve(self) -> dict:
        """{"columns", "rows"}: one row per train step, counted from 1."""
        a = self.array()[:, len(HEALTH_KEYS):]
        return {"columns": ["step", "beta", *CURVE_KEYS],
                "rows": [[i + 1, b, *map(float, r)]
                         for i, (b, r) in enumerate(zip(self.betas, a))]}


def write_curve(path: str, curve: dict) -> None:
    """train_curve.json with one row per line."""
    rows = ",\n  ".join(json.dumps(r) for r in curve["rows"])
    with open(path, "w") as f:
        f.write(f'{{"columns": {json.dumps(curve["columns"])},\n'
                f' "rows": [\n  {rows}\n ]}}\n')


def last_row(curve: dict) -> dict:
    """The curve's last row by column name (empty for no train step)."""
    rows = curve["rows"]
    return dict(zip(curve["columns"], rows[-1])) if rows else {}


def default_outdir(name: str) -> str:
    return os.path.join("outputs", f"record_{name}")


def start(name: str, outdir: str, extra: Sequence[str] = (), device=None):
    """The record's Experiment at its protocol (plus `extra` overrides),
    with a TrainRecord on its trainer; a restored run's kept rows are
    loaded, and with `save=true` the rows are kept beside every era's
    checkpoint. Returns (experiment, record)."""
    from l2hmc_torch.experiment import build_experiment
    ex = build_experiment([*RECORDS[name], *extra, f"outdir={outdir}"],
                          device=device)
    rec = TrainRecord(ex.trainer)
    kept = os.path.join(outdir, "train_record.pt")
    ex.setup()
    if ex.trainer.step > 0:
        # restored from a checkpoint: its steps' rows were kept beside it
        rec.load(kept)
        if len(rec.saved) != ex.trainer.step:
            raise RuntimeError(f"{kept} holds {len(rec.saved)} train steps, "
                               f"the checkpoint {ex.trainer.step}")
    if ex.cfg.save:
        checkpoint = ex._era_checkpoint

        def era_checkpoint(era, x, beta):
            checkpoint(era, x, beta)
            if ex.is_main:
                rec.save(kept)

        ex._era_checkpoint = era_checkpoint
    return ex, rec


def finish(ex, rec: TrainRecord, summary: dict, outdir: str,
           commit: Optional[str] = None) -> dict:
    """Add se, the flowed sector statistics, device and commit to an
    `ex.run()` summary; write it, train_health.json and train_curve.json
    under outdir; return it."""
    summary["se"] = add_se(ex, summary)
    for job in ("eval", "hmc"):
        stats, se = flow_sectors(ex.trainer.histories[job])
        summary[f"{job}_stats"].update(stats)
        summary["se"][f"{job}_stats"].update(se)
    summary["device"] = device_line(ex.device)
    summary["commit"] = commit_id(commit)
    write_json(os.path.join(outdir, "summary.json"), summary)
    write_json(os.path.join(outdir, "train_health.json"), rec.health())
    write_curve(os.path.join(outdir, "train_curve.json"), rec.curve())
    return summary


def run(name: str, outdir: Optional[str] = None,
        extra: Sequence[str] = (), device=None,
        commit: Optional[str] = None) -> dict:
    """One record at its protocol (plus `extra` overrides); writes and
    returns `<outdir>/summary.json`."""
    outdir = outdir or default_outdir(name)
    ex, rec = start(name, outdir, extra, device)
    return finish(ex, rec, ex.run(), outdir, commit)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s] %(message)s")
    pos, ovs, opts = split_args(sys.argv[1:] if argv is None else argv)
    if not pos or pos[0] not in RECORDS:
        raise SystemExit(f"usage: python -m l2hmc_torch.records.quality "
                         f"{{{'|'.join(RECORDS)}}} [outdir] [key=value ...]")
    name = pos[0]
    outdir = pos[1] if len(pos) > 1 else default_outdir(name)
    s = run(name, outdir, ovs, device=opts.get("device"),
            commit=opts.get("commit"))
    print(json.dumps({k: s[k] for k in ("improvement", "eval_stats",
                                        "hmc_stats", "se", "device")},
                     indent=1, default=float))
    with open(os.path.join(outdir, "train_health.json")) as f:
        print(f.read())
    with open(os.path.join(outdir, "train_curve.json")) as f:
        print("train_curve.json, last row:",
              json.dumps(last_row(json.load(f))))
    ref = opts.get("ref")
    if ref:
        with open(ref) as f:
            print(json.dumps(compare(s, json.load(f)), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
