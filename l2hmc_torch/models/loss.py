"""L2HMC training loss, the U(1) terms.

PyTorch counterpart of the JAX package's `models/loss.py` (after the
reference's `LatticeLoss`, src/l2hmc/loss/pytorch/loss.py:21-210). The
loss rewards proposals that move observables, weighted by the acceptance
probability:

  charge term (:72-92):  qloss = E[acc (sinQ(x2) - sinQ(x1))^2]
  plaq term   (:57-70):  ploss = E[acc (P(x2) - P(x1))^2]
  rmse term  (:128-148):  rloss = E[acc mean|x2 - x1|^2]

Each term enters either as -term/weight or, with use_mixed_loss, as
mixed(term + 1e-4, w) = w/term - term/w; both are minimized. The SU(3)
flowed-charge term is not ported yet.
"""
from __future__ import annotations

import torch

from l2hmc_torch.configs import LossConfig
from l2hmc_torch.ops.lattice_u1 import LatticeU1


def mixed_loss(loss: torch.Tensor, weight: float) -> torch.Tensor:
    return weight / loss - loss / weight


def _finite_or_zero(term: torch.Tensor) -> torch.Tensor:
    """Zero out per-chain loss entries from blown-up proposals (loss.py:40):
    a diverged chain's NaN must not poison the batch mean (and with it,
    via the trainer's nan_to_num, the whole gradient)."""
    return torch.where(torch.isfinite(term), term, torch.zeros_like(term))


class LatticeLoss:
    def __init__(self, lattice: LatticeU1, config: LossConfig):
        if not isinstance(lattice, LatticeU1):
            raise NotImplementedError("only the U(1) loss is ported")
        self.lattice = lattice
        self.config = config

    def __call__(self, x_init, x_prop, acc):
        return self.calc_loss(x_init, x_prop, acc)

    def _term(self, term: torch.Tensor, weight: float) -> torch.Tensor:
        term = _finite_or_zero(term)
        if self.config.use_mixed_loss:
            return torch.mean(mixed_loss(term + 1e-4, weight))
        return torch.mean(-term / weight)

    def _plaq_loss(self, w1, w2, acc):
        p1 = torch.sum(torch.cos(w1), dim=(1, 2))
        p2 = torch.sum(torch.cos(w2), dim=(1, 2))
        return self._term(acc * (p2 - p1) ** 2, self.config.plaq_weight)

    def _charge_loss(self, w1, w2, acc):
        q1 = self.lattice.sin_charges(wloops=w1)
        q2 = self.lattice.sin_charges(wloops=w2)
        return self._term(acc * (q2 - q1) ** 2, self.config.charge_weight)

    def _rmse_loss(self, x_init, x_prop, acc):
        dx2 = (x_prop - x_init) ** 2
        dx2 = dx2.reshape(dx2.shape[0], -1).mean(dim=1)
        return self._term(acc * dx2, self.config.rmse_weight)

    def calc_loss(self, x_init, x_prop, acc) -> torch.Tensor:
        """Weighted sum of the active terms (loss.py:194-210)."""
        w1 = self.lattice.wilson_loops(x_init)
        w2 = self.lattice.wilson_loops(x_prop)
        total = torch.zeros((), dtype=acc.dtype, device=acc.device)
        if self.config.plaq_weight > 0:
            total = total + self._plaq_loss(w1, w2, acc)
        if self.config.charge_weight > 0:
            total = total + self._charge_loss(w1, w2, acc)
        if self.config.rmse_weight > 0:
            total = total + self._rmse_loss(x_init, x_prop, acc)
        return total

    def lattice_metrics(self, xinit, xout=None) -> dict:
        """plaqs/p4x4/intQ/sinQ (+ dQint/dQsin vs xinit) (loss.py:94-110)."""
        metrics = self.lattice.calc_metrics(xinit)
        if xout is not None:
            wl = self.lattice.wilson_loops(xout)
            qint = self.lattice.int_charges(wloops=wl)
            qsin = self.lattice.sin_charges(wloops=wl)
            metrics.update({
                "dQint": torch.abs(qint - metrics["intQ"]),
                "dQsin": torch.abs(qsin - metrics["sinQ"]),
            })
        return metrics
