"""Per-era statistics of training runs, side by side.

    python -m l2hmc_torch.records.curve_eras [--nepoch 150] [--skip 25] \
        RUN [RUN ...]

RUN is a `train_history.npz` (either package's Experiment writes one into
its outdir; with `steps.log=1` it holds every train step) or a record's
`train_curve.json` (one row per train step). Per era of NEPOCH train steps
it prints one JSON line with the chain means of acc, sumlogdet and the
plaquette at the era's first step ("first"), over its steps 2..SKIP
("early") and over its steps SKIP+1..NEPOCH ("late"); xeps, veps and
grad_norm at the era's last step; and the era's steps with a non-finite
gradient entry (null where the run does not keep them).
"""
from __future__ import annotations

import json
import sys

import numpy as np

SERIES = ("acc", "sumlogdet", "plaqs")


def load(path: str) -> dict:
    """{key: per-step array}: chain means of SERIES, the mean step sizes,
    grad_norm and grad_nonfinite where the run has them."""
    if path.endswith(".json"):
        with open(path) as f:
            curve = json.load(f)
        a = np.asarray(curve["rows"], dtype=np.float64)
        return {c: a[:, i] for i, c in enumerate(curve["columns"])}
    h = np.load(path)
    out = {}
    for k in (*SERIES, "xeps", "veps"):
        if k in h.files:
            v = np.asarray(h[k], dtype=np.float64)
            # (chains, steps) or (leapfrog steps, steps): mean over axis 0
            out[k] = v.reshape(-1, v.shape[-1]).mean(axis=0)
    for k in ("grad_norm", "grad_nonfinite"):
        if k in h.files:
            out[k] = np.asarray(h[k], dtype=np.float64).reshape(-1)
    return out


def eras(run: dict, nepoch: int, skip: int) -> list[dict]:
    n = len(run["acc"])
    out = []
    for era, lo in enumerate(range(0, n, nepoch)):
        hi = min(lo + nepoch, n)
        row = {"era": era, "steps": [lo + 1, hi]}
        for part, (a, b) in {"first": (lo, lo + 1),
                             "early": (lo + 1, min(lo + skip, hi)),
                             "late": (min(lo + skip, hi), hi)}.items():
            row[part] = {k: (float(run[k][a:b].mean()) if k in run and b > a
                             else None) for k in SERIES}
        for k in ("xeps", "veps", "grad_norm"):
            row[f"{k}_end"] = float(run[k][hi - 1]) if k in run else None
        row["steps_grad_nonfinite"] = (
            int(np.count_nonzero(run["grad_nonfinite"][lo:hi]))
            if "grad_nonfinite" in run else None)
        out.append(row)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"nepoch": 150, "skip": 25}
    paths = []
    while argv:
        a = argv.pop(0)
        if a.startswith("--"):
            opts[a[2:]] = int(argv.pop(0))
        else:
            paths.append(a)
    for path in paths:
        for row in eras(load(path), opts["nepoch"], opts["skip"]):
            print(json.dumps({"run": path, **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
