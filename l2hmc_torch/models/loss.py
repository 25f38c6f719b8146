"""L2HMC training loss.

PyTorch counterpart of the JAX package's `models/loss.py` (after the
reference's `LatticeLoss`, src/l2hmc/loss/pytorch/loss.py:21-210). The
loss rewards proposals that move observables, weighted by the acceptance
probability:

  charge term (:72-92):  qloss = E[acc (sinQ(x2) - sinQ(x1))^2]
  plaq term   (:57-70):  ploss = E[acc (P(x2) - P(x1))^2]
  rmse term  (:128-148):  rloss = E[acc mean|x2 - x1|^2]

Each term enters either as -term/weight or, with use_mixed_loss, as
mixed(term + 1e-4, w) = w/term - term/w; both are minimized.

The reference's `_plaq_loss` sums U(1) Wilson loops over axes 2+ of a
(nb, nt, nx) array, which cannot broadcast against acc (nb,); here the
plaquette sum runs over all non-chain axes for U(1) and per plane for
SU(3), so the term is usable for both groups.

SU(3) only, with loss.charge_flow_nsteps > 0: the charge term is taken on
the Wilson-flowed clover charge of both fields (ops/wilson_flow.py), the
whole flow recomputed in the backward pass.
"""
from __future__ import annotations

from typing import Union

import torch
from torch.utils.checkpoint import checkpoint

from l2hmc_torch.configs import LossConfig
from l2hmc_torch.ops.lattice_su3 import LatticeSU3
from l2hmc_torch.ops.lattice_u1 import LatticeU1

Lattice = Union[LatticeU1, LatticeSU3]


def mixed_loss(loss: torch.Tensor, weight: float) -> torch.Tensor:
    return weight / loss - loss / weight


def _finite_or_zero(term: torch.Tensor) -> torch.Tensor:
    """Zero out per-chain loss entries from blown-up proposals (loss.py:40):
    a diverged chain's NaN must not poison the batch mean (and with it,
    via the trainer's nan_to_num, the whole gradient)."""
    return torch.where(torch.isfinite(term), term, torch.zeros_like(term))


class LatticeLoss:
    def __init__(self, lattice: Lattice, config: LossConfig):
        self.lattice = lattice
        self.config = config
        self.is_u1 = isinstance(lattice, LatticeU1)

    def __call__(self, x_init, x_prop, acc):
        return self.calc_loss(x_init, x_prop, acc)

    def _term(self, term: torch.Tensor, weight: float) -> torch.Tensor:
        term = _finite_or_zero(term)
        if self.config.use_mixed_loss:
            return torch.mean(mixed_loss(term + 1e-4, weight))
        return torch.mean(-term / weight)

    def _plaq_sums(self, wl: torch.Tensor) -> torch.Tensor:
        if self.is_u1:
            return torch.sum(torch.cos(wl), dim=(1, 2))          # (nb,)
        return wl.real.sum(dim=tuple(range(2, wl.ndim)))         # (6, nb)

    def _plaq_loss(self, w1, w2, acc):
        p1 = self._plaq_sums(w1)
        p2 = self._plaq_sums(w2)
        return self._term(acc * (p2 - p1) ** 2, self.config.plaq_weight)

    def _charge_loss(self, w1, w2, acc):
        q1 = self.lattice.sin_charges(wloops=w1)
        q2 = self.lattice.sin_charges(wloops=w2)
        return self._term(acc * (q2 - q1) ** 2, self.config.charge_weight)

    def _rmse_loss(self, x_init, x_prop, acc):
        dx = x_prop - x_init
        dx2 = dx.real ** 2 + dx.imag ** 2 if dx.is_complex() else dx ** 2
        dx2 = dx2.reshape(dx2.shape[0], -1).mean(dim=1)
        return self._term(acc * dx2, self.config.rmse_weight)

    def _flowed_clover_charge(self, x: torch.Tensor) -> torch.Tensor:
        """Wilson-flow x (charge_flow_nsteps x charge_flow_eps, RK3) and
        return the clover topological charge, differentiably. Where a
        gradient is wanted the whole flow runs under checkpoint: the
        backward recomputes the flow (whose steps are checkpointed in
        turn) instead of holding nsteps lattices' worth of internals."""
        from l2hmc_torch.ops import su3_comp as comp
        from l2hmc_torch.ops import wilson_flow as wf
        lat = tuple(x.shape[2:-2])
        nb = x.shape[0]
        eps = float(self.config.charge_flow_eps)
        ns = int(self.config.charge_flow_nsteps)

        def flow_q(y):
            res = wf.flow(comp.from_complex_lattice(y), eps, ns, lat, nb)
            return comp.topo_charge_clover(res.x, lat, nb)

        if torch.is_grad_enabled() and x.requires_grad:
            return checkpoint(flow_q, x, use_reentrant=False,
                              preserve_rng_state=False)
        return flow_q(x)

    def _flowed_charge_loss(self, x_init, x_prop, acc):
        # x_init carries no parameter dependence
        with torch.no_grad():
            q1 = self._flowed_clover_charge(x_init)
        q2 = self._flowed_clover_charge(x_prop)
        return self._term(acc * (q2 - q1) ** 2, self.config.charge_weight)

    def calc_loss(self, x_init, x_prop, acc) -> torch.Tensor:
        """Weighted sum of the active terms (loss.py:194-210)."""
        w1 = self.lattice.wilson_loops(x_init)
        w2 = self.lattice.wilson_loops(x_prop)
        total = torch.zeros((), dtype=acc.dtype, device=acc.device)
        if self.config.plaq_weight > 0:
            total = total + self._plaq_loss(w1, w2, acc)
        if self.config.charge_weight > 0:
            flow_ns = int(getattr(self.config, "charge_flow_nsteps", 0))
            if flow_ns > 0 and not self.is_u1:
                total = total + self._flowed_charge_loss(x_init, x_prop,
                                                         acc)
            else:
                total = total + self._charge_loss(w1, w2, acc)
        if self.config.rmse_weight > 0:
            total = total + self._rmse_loss(x_init, x_prop, acc)
        return total

    def lattice_metrics(self, xinit, xout=None) -> dict:
        """plaqs/intQ/sinQ (U(1) also p4x4), + dQint/dQsin vs xinit
        (loss.py:94-110)."""
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
