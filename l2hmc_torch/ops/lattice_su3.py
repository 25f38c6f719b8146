"""4D SU(3) lattice gauge theory: Wilson/DBW2 action, force, observables.

PyTorch counterpart of the JAX package's `ops/lattice_su3.py` (after the
reference's `LatticeSU3`, src/l2hmc/lattice/su3/pytorch/lattice.py:41-349).
Field layout: x[nb, 4, nt, nx, ny, nz, 3, 3] complex, v the same shape (TAH
matrices).

Plaquettes are batched 3x3 matmuls + rolls over the 6 (mu, nu) planes; the
optional `c1` rectangle terms give the DBW2/Iwasaki family (arXiv
hep-lat/0512017, as in lattice.py:83-112).

The force is the analytic staple derivative with an autograd route as the
correctness oracle; both give dS/dx = dS/dRe + i dS/dIm contracted to the
algebra via projectTAH(dS/dx · x†) (lattice.py:299-308). The trajectory
itself runs in the component engine (ops/su3_comp.py); this module serves
the observables, the loss and the tests.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from l2hmc_torch.ops import su3 as g


class Charges(NamedTuple):
    intQ: torch.Tensor
    sinQ: torch.Tensor


def _to_lattice(x: torch.Tensor, latvolume) -> torch.Tensor:
    return x.reshape(x.shape[0], 4, *latvolume, 3, 3)


def _roll(a: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    return torch.roll(a, shift, dims=axis)


def _plane_loops(x: torch.Tensor, u: int, v: int, roll=_roll):
    """yuv = U_u(n) U_v(n+u), yvu = U_v(n) U_u(n+v) for one (u, v) plane.
    Axis u+1 of the per-direction field (nb, nt, nx, ny, nz, 3, 3) is the
    lattice direction u (lattice.py:170-176)."""
    xu = x[:, u]
    xv = x[:, v]
    yuv = xu @ roll(xv, -1, axis=u + 1)
    yvu = xv @ roll(xu, -1, axis=v + 1)
    return xu, xv, yuv, yvu


def _plane_rect_traces(u, v, xu, xv, yuv, yvu, roll=_roll):
    """Traces of the two 2x1 rectangles in the (u, v) plane
    (lattice.py:180-195)."""
    yu = roll(xu, -1, axis=v + 1)
    yv = roll(xv, -1, axis=u + 1)
    uu = g.mul(xv, yuv, adjoint_a=True)
    ur = g.mul(xu, yvu, adjoint_a=True)
    ul = g.mul(yuv, yu, adjoint_b=True)
    ud = g.mul(yvu, yv, adjoint_b=True)
    ul_ = roll(ul, -1, axis=u + 1)
    ud_ = roll(ud, -1, axis=v + 1)
    tr_urul = g.trace(g.mul(ur, ul_, adjoint_b=True))
    tr_uuud = g.trace(g.mul(uu, ud_, adjoint_b=True))
    return tr_urul, tr_uuud


def wilson_loops(x: torch.Tensor, latvolume, needs_rect: bool = False,
                 roll=_roll):
    """Stacked plaquette traces (6, nb, nt, nx, ny, nz) over the 6 planes,
    plus rectangle traces (12, ...) when requested (lattice.py:157-199)."""
    x = _to_lattice(x, latvolume)
    plaqs_ = []
    rects = []
    for u in range(1, 4):
        for v in range(0, u):
            xu, xv, yuv, yvu = _plane_loops(x, u, v, roll=roll)
            plaqs_.append(g.trace(g.mul(yuv, yvu, adjoint_b=True)))
            if needs_rect:
                rects.extend(_plane_rect_traces(u, v, xu, xv, yuv, yvu,
                                                roll=roll))
    ps = torch.stack(plaqs_)
    rs = torch.stack(rects) if needs_rect else None
    return ps, rs


def coeffs(beta, c1: float):
    """Plaquette/rectangle couplings (lattice.py:83-91)."""
    return {"plaq": beta * (1.0 - 8.0 * c1), "rect": beta * c1}


def _chain_sums(a: torch.Tensor) -> torch.Tensor:
    """(planes, nb, *lat) real -> (nb,)."""
    return a.sum(dim=tuple(range(2, a.ndim))).sum(0)


def action(x: torch.Tensor, beta, latvolume, c1: float = 0.0,
           roll=_roll) -> torch.Tensor:
    """S = -(1/3) [beta(1-8c1) sum Re tr P + beta c1 sum Re tr R] per chain
    (lattice.py:252-269)."""
    cs = coeffs(beta, c1)
    ps, rs = wilson_loops(x, latvolume, needs_rect=(c1 != 0), roll=roll)
    act = cs["plaq"] * _chain_sums(ps.real)
    if c1 != 0:
        act = act + cs["rect"] * _chain_sums(rs.real)
    return act * (-1.0 / 3.0)


# ---------------------------------------------------------------------------
# Forces
# ---------------------------------------------------------------------------
def _wirtinger_grad(f, x: torch.Tensor) -> torch.Tensor:
    """d(real f)/dx as dRe + i dIm, taken on the real and imaginary parts
    as separate real leaves (so it holds whatever convention autograd has
    for complex leaves); this is what the reference contracts with x†
    (lattice.py:306-308)."""
    with torch.enable_grad():
        xr = x.real.detach().clone().requires_grad_()
        xi = x.imag.detach().clone().requires_grad_()
        s = torch.sum(f(torch.complex(xr, xi)))
        gr, gi = torch.autograd.grad(s, (xr, xi))
    return torch.complex(gr, gi)


def grad_action_autodiff(x: torch.Tensor, beta, latvolume,
                         c1: float = 0.0) -> torch.Tensor:
    """Algebra-valued force via autograd: projectTAH(dS/dx · x†)."""
    shape = x.shape
    xl = _to_lattice(x, latvolume)
    dsdx = _wirtinger_grad(lambda y: action(y, beta, latvolume, c1), xl)
    f = g.projectTAH(dsdx @ g.adjoint(xl.detach()))
    return f.reshape(shape)


def staples(x: torch.Tensor, latvolume, roll=_roll) -> torch.Tensor:
    """Sum of the 6 plaquette staples A_u(n) for every link U_u(n).

    For S ⊃ tr[U_u(n) A_u(n)], the staple in the (u, v) plane is
      A = U_v(n+u) U_u†(n+v) U_v†(n)  +  U_v†(n+u-v) U_u†(n-v) U_v(n-v).
    Returns shape (nb, 4, *latvolume, 3, 3)."""
    x = _to_lattice(x, latvolume)
    out = []
    for u in range(4):
        acc = None
        xu = x[:, u]
        for v in range(4):
            if v == u:
                continue
            xv = x[:, v]
            xv_pu = roll(xv, -1, axis=u + 1)              # U_v(n+u)
            xu_pv = roll(xu, -1, axis=v + 1)              # U_u(n+v)
            up = xv_pu @ g.adjoint(xu_pv) @ g.adjoint(xv)
            xv_mv = roll(xv, 1, axis=v + 1)               # U_v(n-v)
            xu_mv = roll(xu, 1, axis=v + 1)               # U_u(n-v)
            xv_pu_mv = roll(xv_mv, -1, axis=u + 1)        # U_v(n+u-v)
            down = g.adjoint(xv_pu_mv) @ g.adjoint(xu_mv) @ xv_mv
            acc = up + down if acc is None else acc + (up + down)
        out.append(acc)
    return torch.stack(out, dim=1)


def grad_action(x: torch.Tensor, beta, latvolume, c1: float = 0.0,
                roll=_roll) -> torch.Tensor:
    """Closed-form force for the plaquette action.

    For S = -(b/3) sum_p Re tr P (b = beta(1-8c1)): the gradient
    dRe + i dIm of Re tr[U M] w.r.t. U is M†, so dS/dU_u(n) =
    -(b/3) A_u(n)† with A the 6-plaquette staple sum. Contracting as in
    the reference (projectTAH(dS/dU · U†), lattice.py:299-308) and using
    projectTAH(X†) = -projectTAH(X):
        F = (b/3) projectTAH(U A)
    Held against the autograd route in the tests; the rectangle (c1 != 0)
    terms take that route."""
    if c1 != 0.0:
        return grad_action_autodiff(x, beta, latvolume, c1)
    shape = x.shape
    xl = _to_lattice(x, latvolume)
    b = beta * (1.0 - 8.0 * c1)
    ua = xl @ staples(xl, latvolume, roll=roll)
    f = (b / 3.0) * g.projectTAH(ua)
    return f.reshape(shape)


# ---------------------------------------------------------------------------
# Observables (lattice.py:201-240)
# ---------------------------------------------------------------------------
def plaqs(wl: torch.Tensor, volume: int) -> torch.Tensor:
    """Average plaquette Re tr P / 3 per chain."""
    return _chain_sums(wl.real) / (6 * 3 * volume)


def sin_charges(wl: torch.Tensor, volume: int) -> torch.Tensor:
    return _chain_sums(wl.imag) / (6 * 3 * volume)


def int_charges(wl: torch.Tensor) -> torch.Tensor:
    return _chain_sums(wl.imag) / (32 * math.pi ** 2)


def charges(wl: torch.Tensor, volume: int) -> Charges:
    return Charges(intQ=int_charges(wl), sinQ=sin_charges(wl, volume))


class LatticeSU3:
    """Shape info plus the module-level functions, mirroring the reference
    `LatticeSU3` API."""

    def __init__(self, nchains: int, shape, c1: float = 0.0):
        if len(shape) != 4:
            raise ValueError(
                f"SU(3) lattice shape must be (nt, nx, ny, nz), got {shape}")
        self.g = g
        self.dim = 4
        self.nt, self.nx, self.ny, self.nz = (int(s) for s in shape)
        self.latvolume = (self.nt, self.nx, self.ny, self.nz)
        self.volume = self.nt * self.nx * self.ny * self.nz
        self.c1 = c1
        self.nchains = nchains
        self.xshape = (4, *self.latvolume, 3, 3)
        self._shape = (nchains, *self.xshape)
        self.xdim = math.prod(self.xshape) * 2  # real dof

    def random(self, generator=None, dtype=torch.complex128, device=None):
        return g.random(self._shape, generator, dtype, device)

    def random_momentum(self, generator=None, dtype=torch.complex128,
                        device=None):
        return g.random_momentum(self._shape, generator, dtype, device)

    def kinetic_energy(self, v):
        return g.kinetic_energy(v)

    def action(self, x, beta):
        return action(x, beta, self.latvolume, self.c1)

    def grad_action(self, x, beta):
        return grad_action(x, beta, self.latvolume, self.c1)

    def grad_action_autodiff(self, x, beta):
        return grad_action_autodiff(x, beta, self.latvolume, self.c1)

    def wilson_loops(self, x):
        ps, _ = wilson_loops(x, self.latvolume, needs_rect=False)
        return ps

    def plaqs(self, x=None, wloops=None):
        wl = self.wilson_loops(x) if wloops is None else wloops
        return plaqs(wl, self.volume)

    def charges(self, x=None, wloops=None):
        wl = self.wilson_loops(x) if wloops is None else wloops
        return charges(wl, self.volume)

    def int_charges(self, x=None, wloops=None):
        wl = self.wilson_loops(x) if wloops is None else wloops
        return int_charges(wl)

    def sin_charges(self, x=None, wloops=None):
        wl = self.wilson_loops(x) if wloops is None else wloops
        return sin_charges(wl, self.volume)

    def calc_metrics(self, x):
        wl = self.wilson_loops(x)
        q = charges(wl, self.volume)
        return {
            "plaqs": plaqs(wl, self.volume),
            "intQ": q.intQ,
            "sinQ": q.sinQ,
        }
