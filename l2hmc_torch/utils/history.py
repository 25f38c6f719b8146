"""Metric history accumulation and dataset export.

Counterpart of the reference's `BaseHistory`
(reference src/l2hmc/utils/history.py:235-909): accumulates per-step
metric dicts, returns scalar summaries for logging, reshapes series to
(chain, draw) / (chain, leapfrog, draw) arrays, and exports to xarray/HDF5
when those libraries are present (numpy .npz + json otherwise).
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np

from l2hmc_torch.utils import spans


def grab(x) -> np.ndarray:
    """Tensor (any device) / scalar -> numpy (reference common.py:51-72)."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def summarize_dict(d: dict) -> str:
    parts = []
    for k, v in d.items():
        try:
            arr = grab(v)
            if arr.ndim == 0:
                parts.append(f"{k}={float(arr):.4g}")
            else:
                parts.append(f"{k}={float(arr.mean()):.4g}")
        except (TypeError, ValueError):
            continue
    return " ".join(parts)


class History:
    """Accumulates metric dicts; one instance per job type
    (train/eval/hmc), like the reference's per-job `BaseHistory`."""

    def __init__(self, keys: Optional[list[str]] = None):
        self.history: dict[str, list] = {}
        self.era_metrics: dict[str, dict[str, list]] = {}
        self._era_start: dict[str, int] = {}

    def update(self, metrics: dict[str, Any]) -> dict[str, float]:
        """Append one step's metrics; returns scalar (batch-averaged)
        values for console/logging (history.py:235-264). Each tensor
        grabbed is one read to the host, counted as `host_reads` of the
        current job (utils/spans.py)."""
        avgs = {}
        reads = 0
        for key, val in metrics.items():
            if val is None or key == "mc_states":
                continue
            try:
                arr = grab(val)
            except (TypeError, ValueError):
                # non-array payloads riding the metrics dict (e.g. the
                # "grads" pytree the Trainer emits for histogram logging)
                continue
            reads += hasattr(val, "detach")
            self.history.setdefault(key, []).append(arr)
            try:
                avgs[key] = float(np.mean(arr))
            except (TypeError, ValueError):
                pass
        spans.count("host_reads", reads)
        return avgs

    def era_summary(self, era) -> dict[str, float]:
        """Mean of every scalar-able metric logged since the previous
        era_summary call (history.py:169). Also records the summary in
        era_metrics[era] and advances the per-key era boundary."""
        out = {}
        for key, vals in self.history.items():
            start = self._era_start.get(key, 0)
            sl = vals[start:]
            if not sl:
                continue
            try:
                out[key] = float(np.mean([np.mean(v) for v in sl]))
            except (TypeError, ValueError):
                continue
            self._era_start[key] = len(vals)
        self.era_metrics[str(era)] = out
        return out

    def get_dataset(self) -> dict[str, np.ndarray]:
        """Stack series along the draw axis.

        Mirrors history.py:854-909: [draws] stays 1-D; [draws, chains]
        arrays become (chain, draw); [draws, nlf, chains] become
        (chain, leapfrog, draw).
        """
        out = {}
        for key, vals in self.history.items():
            try:
                arr = np.stack([np.asarray(v) for v in vals])
            except ValueError:
                continue
            if arr.ndim == 2:        # (draw, chain) -> (chain, draw)
                arr = arr.T
            elif arr.ndim == 3:      # (draw, nlf, chain) -> (chain, nlf, draw)
                arr = arr.transpose(2, 1, 0)
            out[key] = arr
        return out

    def to_xarray(self):
        """Optional xarray.Dataset export (history.py:854-892)."""
        import xarray as xr
        dset = {}
        for key, arr in self.get_dataset().items():
            if arr.ndim == 1:
                dims = ["draw"]
            elif arr.ndim == 2:
                dims = ["chain", "draw"]
            else:
                dims = ["chain", "leapfrog", "draw"]
            dset[key] = xr.DataArray(arr, dims=dims)
        return xr.Dataset(dset)

    def load(self, path: str) -> None:
        """Restore accumulated series from a `save`d npz (inverse of
        get_dataset's stacking) so a resumed run appends to its history
        rather than restarting it."""
        data = np.load(path)
        for key in data.files:
            arr = data[key]
            if arr.ndim == 1:          # (draw,)
                steps = [arr[i] for i in range(arr.shape[0])]
            elif arr.ndim == 2:        # (chain, draw)
                steps = [arr[:, i] for i in range(arr.shape[1])]
            else:                      # (chain, nlf, draw)
                steps = [arr[:, :, i].T for i in range(arr.shape[2])]
            self.history[key] = steps
            self._era_start[key] = len(steps)

    def save(self, outdir: str, job_type: str = "train") -> str:
        """npz + summary json; h5 via xarray/h5netcdf when available
        (reference common.py:240-291 h5/netCDF export)."""
        os.makedirs(outdir, exist_ok=True)
        data = self.get_dataset()
        path = os.path.join(outdir, f"{job_type}_history.npz")
        np.savez_compressed(path, **data)
        summary = {
            k: {
                "mean": float(np.mean(v)),
                "std": float(np.std(v)),
                "last": float(np.mean(v[..., -1])) if v.ndim else float(v),
            }
            for k, v in data.items()
        }
        with open(os.path.join(outdir, f"{job_type}_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        try:
            ds = self.to_xarray()
            ds.to_netcdf(os.path.join(outdir, f"{job_type}_dataset.h5"),
                         engine="h5netcdf")
        except Exception:
            pass
        return path
