"""Wilson (gradient) flow for SU(3) gauge fields.

PyTorch counterpart of the JAX package's `ops/wilson_flow.py`. Integrates
the gradient flow dV/dt = Z(V) V, with Z(V) the negative Wilson-action
gradient in the Lie algebra, by Luscher's 3-stage Runge-Kutta
(arXiv:1006.4518, appendix C):

    W0 = V_t
    W1 = exp(1/4 Z0) W0
    W2 = exp(8/9 Z1 - 17/36 Z0) W1
    V_{t+eps} = exp(3/4 Z2 - 8/9 Z1 + 17/36 Z0) W2,   Zi = eps * Z(Wi)

Normalization: the flow generator is beta-independent. With the engine's
convention (su3_comp.force_and_traces returns F = dS/dU projected to the
traceless anti-hermitian algebra, for S = -(beta/3) sum_p Re tr P), the
canonical flow action S_w = 2 sum_p Re tr(1 - P/3) equals S at beta = 2 up
to a constant, so Z = -F(beta=2). Invariant: dS_w/dt = -|F|^2 <= 0.

Flowed observables: the smoothed plaquette and the energy density
E(t) = (2/V) sum_p Re tr(1 - P/3), whose dimensionless combination
t^2 <E(t)> sets the t0 reference scale (t^2 E |_{t0} = 0.3).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from l2hmc_torch.ops import su3_comp as comp

__all__ = ["flow_step", "flow", "flow_observables", "energy_density",
           "flow_complex_lattice", "FlowResult"]

#: RK3 coefficients (Luscher 1006.4518 App. C)
_C0 = 0.25
_C1A, _C1B = 8.0 / 9.0, -17.0 / 36.0
_C2A, _C2B, _C2C = 0.75, -8.0 / 9.0, 17.0 / 36.0


class FlowResult(NamedTuple):
    """Flowed field + per-step observable series. t: (nsteps,) flow times;
    tr: (nsteps, nb) per-chain plaquette Re-trace sums measured at the
    start of each step."""
    x: comp.F3
    t: torch.Tensor
    tr: torch.Tensor


def _z_and_traces(x: comp.F3, lat, nb: int, roll):
    """(flow generator Z = -F(beta=2), per-chain plaquette Re-trace sum).
    The staple force and the trace sum share their plaquette products, so
    each RK stage's observable is free."""
    f, tr = comp.force_and_traces(x, 2.0, lat, nb, roll)
    return comp.scale(f, -1.0), tr


def flow_step(x: comp.F3, eps, lat, nb: int, roll=None):
    """One RK3 Wilson-flow step; returns (x', plaquette-trace sum at x).

    The exponentials are the order-8, twice-squared Taylor expm of the
    learned x-update; a final `reunit` keeps the integration drift-free.
    reunit, not projectSU: the flowed-charge loss differentiates through
    every flow step, and projectSU's backward is NaN at the near-unitary
    inputs this site always sees."""
    if roll is None:
        roll = comp.make_roll(lat, nb)

    z0, tr0 = _z_and_traces(x, lat, nb, roll)
    z0 = comp.scale(z0, eps)
    w1 = comp.mm(comp.expm(comp.scale(z0, _C0), order=8, s=2), x)

    z1, _ = _z_and_traces(w1, lat, nb, roll)
    z1 = comp.scale(z1, eps)
    c1 = comp.add(comp.scale(z1, _C1A), comp.scale(z0, _C1B))
    w2 = comp.mm(comp.expm(c1, order=8, s=2), w1)

    z2, _ = _z_and_traces(w2, lat, nb, roll)
    z2 = comp.scale(z2, eps)
    c2 = comp.add(comp.add(comp.scale(z2, _C2A), comp.scale(z1, _C2B)),
                  comp.scale(z0, _C2C))
    out = comp.mm(comp.expm(c2, order=8, s=2), w2)
    return comp.reunit(out), tr0


def energy_density(tr_sum: torch.Tensor, volume: int) -> torch.Tensor:
    """E = (2/V) sum_p Re tr(1 - P/3) from the plaquette-trace sum (per
    chain). 6V plaquettes at 4D; E -> 0 as the field smooths."""
    return (2.0 / volume) * (6.0 * volume * 3.0 - tr_sum) / 3.0


def flow_observables(t: torch.Tensor, tr: torch.Tensor, volume: int) -> dict:
    """{'t', 'plaq', 't2E'} from the trace sums."""
    plaq = tr / (6.0 * 3.0 * volume)
    t2e = (t[:, None] ** 2) * energy_density(tr, volume)
    return {"t": t, "plaq": plaq, "t2E": t2e}


def flow(x: comp.F3, eps: float, nsteps: int, lat, nb: int,
         roll=None) -> FlowResult:
    """Integrate nsteps RK3 flow steps; the per-step observables (smoothed
    plaquette, t^2 E) ride along.

    Where a gradient is wanted each step runs under
    `torch.utils.checkpoint`: the backward then keeps one lattice per step
    and recomputes the step's internals (3 force evaluations, 3 expm's,
    a few hundred intermediate fields) instead of holding them all for
    every step of the flow."""
    if roll is None:
        roll = comp.make_roll(lat, nb)
    lat = tuple(lat)
    eps = float(eps)

    def step(re, im):
        x2, tr = flow_step(comp.F3(re, im), eps, lat, nb, roll)
        return x2.re, x2.im, tr

    remat = torch.is_grad_enabled() and (x.re.requires_grad
                                         or x.im.requires_grad)
    trs = []
    for _ in range(nsteps):
        if remat:
            re, im, tr = checkpoint(step, x.re, x.im, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            re, im, tr = step(x.re, x.im)
        x = comp.F3(re, im)
        trs.append(tr)
    # trs[i] is measured at the START of step i => time i*eps
    t = torch.arange(nsteps, dtype=x.re.dtype, device=x.re.device) * eps
    tr_all = (torch.stack(trs) if trs
              else x.re.new_zeros((0, nb)))
    return FlowResult(x, t, tr_all)


def flow_complex_lattice(x: torch.Tensor, eps: float, nsteps: int,
                         lat=None):
    """User-surface wrapper on (nb, 4, *lat, 3, 3) complex fields: returns
    (flowed field, {'t', 'plaq', 't2E'} series)."""
    if lat is None:
        lat = tuple(x.shape[2:-2])
    nb = x.shape[0]
    res = flow(comp.from_complex_lattice(x), eps, nsteps, lat, nb)
    out = comp.to_complex_lattice(res.x, lat, nb, x.dtype)
    return out, flow_observables(res.t, res.tr, math.prod(lat))
