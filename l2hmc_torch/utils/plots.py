"""Matplotlib dataset plots + improvement measurement.

The port's own copy of the JAX package's `utils/plots.py` (numpy and
matplotlib only), after the reference's plot_helpers
(reference src/l2hmc/utils/plot_helpers.py:189-266 `measure_improvement`,
plus the per-metric history plots / chain ridgeplots the reference writes
at end of job, common.py:732-900). All functions are headless-safe
(Agg backend) and no-op gracefully if matplotlib is missing.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_metric(arr: np.ndarray, name: str, outdir: str,
                logging_steps: int = 1) -> Optional[str]:
    """One metric's history: per-chain traces + batch mean.

    arr: (draws,) or (chain, draws) or (chain, leapfrog, draws).
    """
    try:
        plt = _plt()
    except ImportError:
        return None
    os.makedirs(outdir, exist_ok=True)
    a = np.asarray(arr)
    if a.ndim == 3:
        a = a.mean(axis=1)
    fig, ax = plt.subplots(figsize=(7, 3.2), constrained_layout=True)
    steps = np.arange(a.shape[-1]) * logging_steps
    if a.ndim == 2:
        nshow = min(len(a), 32)
        for i in range(nshow):
            ax.plot(steps, a[i], lw=0.4, alpha=0.3, color="C0")
        ax.plot(steps, a.mean(0), lw=1.6, color="C1", label="chain mean")
        ax.legend(loc="best", fontsize=8)
    else:
        ax.plot(steps, a, lw=1.2, color="C0")
    ax.set_xlabel("draw")
    ax.set_ylabel(name)
    path = os.path.join(outdir, f"{name}.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_history(history: dict[str, np.ndarray], outdir: str,
                 logging_steps: int = 1,
                 keys: Optional[list[str]] = None) -> list[str]:
    """Plot every (or selected) metric in a history dataset
    (plot_helpers.plot_dataset equivalent)."""
    out = []
    for name, arr in history.items():
        if keys is not None and name not in keys:
            continue
        if not np.issubdtype(np.asarray(arr).dtype, np.number):
            continue
        p = plot_metric(arr, name, outdir, logging_steps)
        if p:
            out.append(p)
    return out


def plot_ridge(series: np.ndarray, name: str, outdir: str,
               nbins: int = 60) -> Optional[str]:
    """Stacked per-chunk distributions of a (chain, draw) series — the
    reference's ridgeplot analogue (plot_helpers ridgeplots)."""
    try:
        plt = _plt()
    except ImportError:
        return None
    os.makedirs(outdir, exist_ok=True)
    a = np.atleast_2d(np.asarray(series, dtype=np.float64))
    flat = a.reshape(-1)
    nchunks = min(8, a.shape[-1])
    chunks = np.array_split(a, nchunks, axis=-1)
    fig, ax = plt.subplots(figsize=(6, 4), constrained_layout=True)
    lo, hi = np.percentile(flat, [0.5, 99.5])
    bins = np.linspace(lo, hi if hi > lo else lo + 1, nbins)
    for i, ch in enumerate(chunks):
        h, edges = np.histogram(ch.reshape(-1), bins=bins, density=True)
        ax.fill_between(0.5 * (edges[1:] + edges[:-1]), i * 1.1,
                        i * 1.1 + h / max(h.max(), 1e-12),
                        alpha=0.6, color=plt.cm.viridis(i / max(nchunks, 2)))
    ax.set_xlabel(name)
    ax.set_yticks([])
    path = os.path.join(outdir, f"{name}_ridge.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def measure_improvement(hist_eval: dict, hist_hmc: dict,
                        outdir: Optional[str] = None) -> float:
    """mean(dQint_eval) / mean(dQint_hmc) (plot_helpers.py:189-266);
    written to model_improvement.txt when outdir given."""
    if "dQint" not in hist_eval or "dQint" not in hist_hmc:
        return float("nan")
    denom = float(np.mean(hist_hmc["dQint"]))
    improvement = float(np.mean(hist_eval["dQint"])) / max(denom, 1e-16)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "model_improvement.txt"), "w") as f:
            f.write(f"{improvement}\n")
    return improvement
