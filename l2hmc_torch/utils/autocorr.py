"""Autocorrelation analysis: integrated autocorrelation time + ESS.

The reference reports tunneling rates (dQint/dQsin) but never computes
tau_int/ESS itself; the rebuild's north-star metrics (BASELINE.json:
"ESS per MD step; acceptance rate; tau_int within 5%") need them, so this
module adds the standard estimators:

  * tau_int via the self-consistent windowing of Madras-Sokal / Wolff
    (automatic window c*tau, default c=5)
  * ESS = N / (2 tau_int) per chain, and pooled across chains
"""
from __future__ import annotations

import numpy as np


def autocorr_func_1d(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation function via FFT."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 2:
        return np.ones(1)
    x = x - x.mean()
    # zero-pad to 2^k for FFT efficiency
    f = np.fft.rfft(x, n=2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:n]
    if acf[0] == 0:
        return np.ones(n)
    return acf / acf[0]


def integrated_autocorr_time(
    x: np.ndarray, c: float = 5.0, tol: float = 0.0
) -> float:
    """Madras-Sokal tau_int with automatic windowing: the smallest window
    M such that M >= c * tau_int(M)."""
    acf = autocorr_func_1d(x)
    # Sokal convention: tau_int(M) = 1/2 + sum_{t=1..M} rho(t); iid -> 1/2
    taus = np.cumsum(acf) - 0.5
    window = np.arange(len(taus)) >= c * taus
    if window.any():
        m = int(np.argmax(window))
        return float(max(taus[m], 0.5))
    return float(max(taus[-1], 0.5))


def effective_sample_size(x: np.ndarray, c: float = 5.0) -> float:
    """ESS = N / (2 tau_int) for a single series."""
    tau = integrated_autocorr_time(x, c=c)
    return len(x) / (2.0 * tau)


def chain_stats(series: np.ndarray, c: float = 5.0) -> dict:
    """Per-chain and pooled stats for a (chain, draw) array.

    Returns tau_int (mean over chains), ESS summed over chains, and ESS
    per draw (the per-MD-step efficiency used in BASELINE.json).
    """
    arr = np.atleast_2d(np.asarray(series, dtype=np.float64))
    nchains, ndraws = arr.shape
    taus = np.array([integrated_autocorr_time(arr[i], c=c)
                     for i in range(nchains)])
    ess = ndraws / (2.0 * taus)
    return {
        "tau_int": float(taus.mean()),
        "tau_int_std": float(taus.std()),
        "ess_total": float(ess.sum()),
        "ess_per_chain": float(ess.mean()),
        "ess_per_step": float(ess.sum() / (nchains * ndraws)),
        "nchains": nchains,
        "ndraws": ndraws,
    }


def tunneling_rate(intQ: np.ndarray) -> float:
    """Mean |Q_{t+1} - Q_t| over draws and chains — the dQint observable
    the reference maximizes (its headline sampler-quality number)."""
    q = np.atleast_2d(np.asarray(intQ, dtype=np.float64))
    return float(np.mean(np.abs(np.diff(np.round(q), axis=-1))))
