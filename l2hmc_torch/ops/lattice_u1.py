"""2D U(1) lattice gauge theory: Wilson action, force, observables.

PyTorch counterpart of the JAX package's `ops/lattice_u1.py` (after the
reference's `LatticeU1`, src/l2hmc/lattice/u1/pytorch/lattice.py:50-308).
Link field layout: x[(nb,) 2, nt, nx] of phase angles, or flat
(nb, 2*nt*nx); axis 0 of the non-batch dims is the direction mu (0 = t,
1 = x).

The force is closed form (the plaquette staple derivative). On the device
path `LatticeU1.grad_action` goes through the fused force kernel
(ops/kernels/u1_force.py): a CUDA tensor launches the hand-written CUDA
kernel, a CPU tensor takes its plain version.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from l2hmc_torch.ops import u1 as g

PI = math.pi
TWO_PI = 2.0 * math.pi


class Charges(NamedTuple):
    intQ: torch.Tensor
    sinQ: torch.Tensor


def plaq_exact(beta) -> torch.Tensor:
    """Exact infinite-volume average plaquette <cos W> = I1(beta)/I0(beta),
    from the exponentially scaled i1e/i0e (their ratio equals i1/i0).
    Computed in float32, like the JAX package."""
    beta = torch.as_tensor(beta, dtype=torch.float32)
    return torch.special.i1e(beta) / torch.special.i0e(beta)


def project_angle(x: torch.Tensor) -> torch.Tensor:
    """Map angles into [-pi, pi) (lattice.py:45-47)."""
    return x - TWO_PI * torch.floor((x + PI) / TWO_PI)


def _to_lattice(x: torch.Tensor, nt: int, nx: int) -> torch.Tensor:
    return x.reshape(x.shape[0], 2, nt, nx)


def wilson_loops(x: torch.Tensor, nt: int, nx: int) -> torch.Tensor:
    """1x1 Wilson loops W[t,x] = xu[t,x] + xv[t+1,x] - xu[t,x+1] - xv[t,x].
    Returns shape (nb, nt, nx)."""
    x = _to_lattice(x, nt, nx)
    xu = x[:, 0]
    xv = x[:, 1]
    return (xu + torch.roll(xv, -1, dims=1) - torch.roll(xu, -1, dims=2)
            - xv)


def wilson_loops4x4(x: torch.Tensor, nt: int, nx: int) -> torch.Tensor:
    """Closed 4x4 Wilson loops.

    W4[n] = sum_k xu(n + k e1) + sum_k xv(n + 4 e1 + k e2)
          - sum_k xu(n + k e1 + 4 e2) - sum_k xv(n + k e2),  k = 0..3,
    with direction 0 (xu) stepping along the t axis and direction 1 (xv)
    along the x axis, as in the JAX package (which closes the reference's
    open path, lattice.py:161-186).
    """
    x = _to_lattice(x, nt, nx)
    xu = x[:, 0]
    xv = x[:, 1]
    out = torch.zeros_like(xu)
    for k in range(4):
        out = out + torch.roll(xu, -k, dims=1)
        out = out + torch.roll(xv, (-4, -k), dims=(1, 2))
        out = out - torch.roll(xu, (-k, -4), dims=(1, 2))
        out = out - torch.roll(xv, -k, dims=2)
    return out


def action(x: torch.Tensor, beta, nt: int, nx: int) -> torch.Tensor:
    """Wilson action S = beta * sum_p (1 - cos W_p) per chain."""
    return action_from_wloops(wilson_loops(x, nt, nx), beta)


def action_from_wloops(wloops: torch.Tensor, beta) -> torch.Tensor:
    return beta * torch.sum(1.0 - torch.cos(wloops), dim=(1, 2))


def plaq_adjoint(y: torch.Tensor, shape) -> torch.Tensor:
    """The adjoint A^T of the linear plaquette map W = A x:
        (A^T y)_u[t,x] = y[t,x] - y[t,x-1]
        (A^T y)_v[t,x] = y[t-1,x] - y[t,x]
    so that dS/dx = beta * A^T sin(W)."""
    du = y - torch.roll(y, 1, dims=2)
    dv = torch.roll(y, 1, dims=1) - y
    return torch.stack([du, dv], dim=1).reshape(shape)


def grad_action(x: torch.Tensor, beta, nt: int, nx: int) -> torch.Tensor:
    """Closed-form dS/dx = beta * A^T sin(A x):
        dS/dxu[t,x] = beta (sin W[t,x] - sin W[t,x-1])
        dS/dxv[t,x] = beta (sin W[t-1,x] - sin W[t,x])
    """
    w = wilson_loops(x, nt, nx)
    return beta * plaq_adjoint(torch.sin(w), x.shape)


def plaqs(wloops: torch.Tensor) -> torch.Tensor:
    """<cos W> per chain (lattice.py:188-203)."""
    return torch.mean(torch.cos(wloops), dim=(1, 2))


def plaqs4x4(wloops4x4: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.cos(wloops4x4), dim=(1, 2))


def sin_charges(wloops: torch.Tensor) -> torch.Tensor:
    """sinQ = sum sin(W) / 2pi per chain (lattice.py:221-224)."""
    return torch.sum(torch.sin(wloops), dim=(1, 2)) / TWO_PI


def int_charges(wloops: torch.Tensor) -> torch.Tensor:
    """intQ = sum proj(W) / 2pi per chain (lattice.py:226-228)."""
    return torch.sum(project_angle(wloops), dim=(1, 2)) / TWO_PI


def charges(wloops: torch.Tensor) -> Charges:
    return Charges(intQ=int_charges(wloops), sinQ=sin_charges(wloops))


def calc_metrics(x: torch.Tensor, nt: int, nx: int) -> dict:
    """plaqs/p4x4/intQ/sinQ metric dict (lattice.py:131-149)."""
    w = wilson_loops(x, nt, nx)
    q = charges(w)
    return {
        "plaqs": plaqs(w),
        "p4x4": plaqs4x4(wilson_loops4x4(x, nt, nx)),
        "intQ": q.intQ,
        "sinQ": q.sinQ,
    }


def plaqs_diff(x: torch.Tensor, beta, nt: int, nx: int) -> torch.Tensor:
    """plaq_exact(beta) - plaqs(x) per chain (lattice.py:119-129)."""
    w = wilson_loops(x, nt, nx)
    return plaq_exact(beta).to(x.dtype).to(x.device) - plaqs(w)


class LatticeU1:
    """Shape info plus the module-level functions, mirroring the reference
    API."""

    def __init__(self, nchains: int, shape):
        if len(shape) != 2:
            raise ValueError(f"U(1) lattice shape must be (nt, nx), got {shape}")
        self.nt, self.nx = (int(s) for s in shape)
        self.nchains = nchains

    def kinetic_energy(self, v):
        return g.kinetic_energy(v)

    def action(self, x, beta):
        return action(x, beta, self.nt, self.nx)

    def grad_action(self, x, beta):
        """dS/dx through the fused force kernel: the CUDA kernel for a
        CUDA tensor, its plain version for a CPU tensor; differentiable
        either way (autograd.Function with the backward kernel)."""
        from l2hmc_torch.ops.kernels import u1_force
        force, _ = u1_force.force_action_ad(x, beta, self.nt, self.nx)
        return force

    def wilson_loops(self, x):
        return wilson_loops(x, self.nt, self.nx)

    def wilson_loops4x4(self, x):
        return wilson_loops4x4(x, self.nt, self.nx)

    def plaqs(self, x=None, wloops=None):
        w = self.wilson_loops(x) if wloops is None else wloops
        return plaqs(w)

    def plaqs4x4(self, x=None, wloops4x4=None):
        w = self.wilson_loops4x4(x) if wloops4x4 is None else wloops4x4
        return plaqs4x4(w)

    def charges(self, x=None, wloops=None):
        w = self.wilson_loops(x) if wloops is None else wloops
        return charges(w)

    def int_charges(self, x=None, wloops=None):
        w = self.wilson_loops(x) if wloops is None else wloops
        return int_charges(w)

    def sin_charges(self, x=None, wloops=None):
        w = self.wilson_loops(x) if wloops is None else wloops
        return sin_charges(w)

    def calc_metrics(self, x):
        return calc_metrics(x, self.nt, self.nx)

    def plaqs_diff(self, beta, x):
        return plaqs_diff(x, beta, self.nt, self.nx)

    def plaq_exact(self, beta):
        return plaq_exact(beta)
