"""Haar-uniform SU(N) distribution.

PyTorch counterpart of the JAX package's `distributions.py` (after the
reference's `HaarSUN`, src/l2hmc/distributions/pytorch/haarSUN.py:22-64):
sample Haar-uniform SU(N) matrices and evaluate the (constant)
log-density.

Sampling is the QR-of-Ginibre construction (Mezzadri, "How to generate
random matrices from the classical compact groups", arXiv:math-ph/0609050):
the Q of a complex-Gaussian matrix is Haar on U(N) iff the decomposition
is made unique by forcing R's diagonal real-positive. Q is built here by
modified Gram-Schmidt, which produces R_kk = ||column residual|| > 0 by
construction, so the canonical-QR condition holds without a phase fix. A
second orthogonalization pass ("twice is enough", Giraud et al. 2005)
keeps ||Q†Q − I|| at machine eps even in float32. The U(N) draw is then
rotated into SU(N) by the det^{-1/N} phase, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from l2hmc_torch.ops.su3 import det3x3, real_dtype


def _log_haar_volume(n: int) -> float:
    """log of the SU(N) group volume: vol = 2 pi^{(n^2+n-2)/2} /
    (prod_{k=1}^{n-1} k!)."""
    logv = math.log(2.0) + ((n * n + n - 2) / 2.0) * math.log(math.pi)
    for k in range(1, n):
        logv -= math.lgamma(k + 1)
    return logv


def _mgs_unitary(z: torch.Tensor, n: int) -> torch.Tensor:
    """Q factor of batched (..., n, n) complex z via two-pass modified
    Gram-Schmidt over columns. R's diagonal is real-positive by
    construction, so for Ginibre z the result is exactly Haar on U(N)."""
    cols = [z[..., :, k] for k in range(n)]
    for _pass in range(2):
        for k in range(n):
            v = cols[k]
            for j in range(k):
                qj = cols[j]
                # <q_j, v> with conjugation on q_j (batched inner product)
                proj = torch.sum(qj.conj() * v, dim=-1, keepdim=True)
                v = v - proj * qj
            nrm = torch.sqrt(torch.sum(v.real ** 2 + v.imag ** 2, dim=-1,
                                       keepdim=True))
            cols[k] = v / nrm.to(v.dtype)
    return torch.stack(cols, dim=-1)


def _det_phase_to_sun(q: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate Haar-U(N) q into SU(N): q * det(q)^{-1/N} (phase only,
    |det q| = 1). The pushforward of Haar U(N) under this map is Haar
    SU(N) (the convention of the reference haarSUN.py:40-44)."""
    if n == 3:
        det = det3x3(q)
    elif n == 2:
        det = q[..., 0, 0] * q[..., 1, 1] - q[..., 0, 1] * q[..., 1, 0]
    else:
        det = torch.linalg.det(q)
    theta = torch.atan2(det.imag, det.real)
    corr = torch.complex(torch.cos(theta / n), -torch.sin(theta / n))
    return q * corr[..., None, None].to(q.dtype)


class HaarSUN:
    """rsample/log_prob API mirroring the reference (haarSUN.py:30-64)."""

    def __init__(self, n: int = 3, dtype=torch.complex64):
        self.n = n
        self.dtype = dtype
        self._log_vol = _log_haar_volume(n)

    def rsample(self, shape=(), generator: Optional[torch.Generator] = None,
                device=None, draws=None) -> torch.Tensor:
        """Exact Haar-uniform SU(N) samples of batch `shape` (+ (n, n)).
        `draws` = (re, im) standard normals of that full shape replaces the
        generator."""
        rdt = real_dtype(self.dtype)
        full = tuple(shape) + (self.n, self.n)
        if draws is None:
            draws = tuple(torch.randn(full, generator=generator, dtype=rdt,
                                      device=device) for _ in range(2))
        re, im = (d.to(rdt) for d in draws)
        z = torch.complex(re, im) / math.sqrt(2.0)
        q = _mgs_unitary(z.to(self.dtype), self.n)
        return _det_phase_to_sun(q, self.n)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Haar density is uniform: log p = -log vol(SU(N)) per sample."""
        return torch.full(x.shape[:-2], -self._log_vol,
                          dtype=real_dtype(x.dtype), device=x.device)
