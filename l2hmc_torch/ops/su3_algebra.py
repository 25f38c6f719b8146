"""su(3) algebra machinery: generators, structure constants, adjoint
representations, exact-derivative helpers, and a closed-form 3x3 log.

PyTorch counterpart of the JAX package's `ops/su3_algebra.py` (after the
reference's group/su3/tensorflow/utils.py:448-809 — gellMann, su3gen,
su3fabc/su3dabc, SU3Ad/su3ad/su3adapply, diffprojectTAH,
diffprojectTAHCross, diffexp, SU3JacobianTF — plus
group/su3/pytorch/logm.py:15-77 log3x3, group/su3/pytorch/sun.py:22-56
SUN manifold ops, and group/generators.py:18-55 near-identity random
elements). Works on complex (..., 3, 3) tensors like `ops/su3.py`, with
arbitrary leading batch axes.

The structure constants f^{abc} and d^{abc} are computed from the
generators at import, in numpy (two einsum traces), and cast on use.
`su3_gradient` differentiates with autograd, `su3_jacobian` with
`torch.func.jacfwd` over the 8 real tangent coordinates. The random
near-identity elements take a `torch.Generator`, or their uniform draws.

Conventions (identical to ops/su3.py and the reference):
  T^a = -i/2 lambda^a   (traceless anti-hermitian, tr{T^a T^b} = -1/2 d_ab)
  X = X^a T^a,  X^a = -2 tr[T^a X]
  [T^a, T^b] = f^{abc} T^c
  {T^a, T^b} = -1/3 d_ab + i d^{abc} T^c
"""
from __future__ import annotations

import cmath
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from l2hmc_torch.ops import su3 as g

# ---------------------------------------------------------------------------
# Generators (constants, float64 numpy at import; cast on use)
# ---------------------------------------------------------------------------
_S3 = np.sqrt(1.0 / 3.0)

#: the 8 Gell-Mann matrices lambda^a, shape (8, 3, 3) complex
#: (utils.py:544-604)
_GELL_MANN = np.zeros((8, 3, 3), dtype=np.complex128)
_GELL_MANN[0, 0, 1] = _GELL_MANN[0, 1, 0] = 1.0
_GELL_MANN[1, 0, 1] = -1.0j
_GELL_MANN[1, 1, 0] = 1.0j
_GELL_MANN[2, 0, 0] = 1.0
_GELL_MANN[2, 1, 1] = -1.0
_GELL_MANN[3, 0, 2] = _GELL_MANN[3, 2, 0] = 1.0
_GELL_MANN[4, 0, 2] = -1.0j
_GELL_MANN[4, 2, 0] = 1.0j
_GELL_MANN[5, 1, 2] = _GELL_MANN[5, 2, 1] = 1.0
_GELL_MANN[6, 1, 2] = -1.0j
_GELL_MANN[6, 2, 1] = 1.0j
_GELL_MANN[7, 0, 0] = _GELL_MANN[7, 1, 1] = _S3
_GELL_MANN[7, 2, 2] = -2.0 * _S3

#: TAH basis T^a = -i/2 lambda^a (utils.py:610-621)
_SU3GEN = (-0.5j) * _GELL_MANN

# f^{abc}: [T^a, T^b] = f^{abc} T^c, with tr{T^c T^d} = -1/2 d_cd
#   => f^{abc} = -2 tr([T^a, T^b] T^c)       (real antisymmetric)
_COMM = np.einsum("aik,bkj->abij", _SU3GEN, _SU3GEN)
_COMM = _COMM - np.einsum("bik,akj->abij", _SU3GEN, _SU3GEN)
_F_ABC = np.real(-2.0 * np.einsum("abij,cji->abc", _COMM, _SU3GEN))

# d^{abc}: {T^a, T^b} = -1/3 d_ab + i d^{abc} T^c
#   => d^{abc} = 2i tr({T^a, T^b} T^c)       (real, totally symmetric)
_ACOMM = np.einsum("aik,bkj->abij", _SU3GEN, _SU3GEN)
_ACOMM = _ACOMM + np.einsum("bik,akj->abij", _SU3GEN, _SU3GEN)
_D_ABC = np.real(2.0j * np.einsum("abij,cji->abc", _ACOMM, _SU3GEN))


def _const(a: np.ndarray, dtype, device=None) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype=dtype, device=device)


def gell_mann(dtype=torch.complex128, device=None) -> torch.Tensor:
    """The 8 Gell-Mann matrices lambda^a, (8, 3, 3) (utils.py:544-604)."""
    return _const(_GELL_MANN, dtype, device)


def su3gen(dtype=torch.complex128, device=None) -> torch.Tensor:
    """TAH generators T^a = -i/2 lambda^a, (8, 3, 3); tr{T^a T^b} = -1/2
    d_ab (utils.py:610-621)."""
    return _const(_SU3GEN, dtype, device)


def fabc(dtype=torch.float64, device=None) -> torch.Tensor:
    """Antisymmetric structure constants f^{abc}, (8, 8, 8)."""
    return _const(_F_ABC, dtype, device)


def dabc(dtype=torch.float64, device=None) -> torch.Tensor:
    """Symmetric structure constants d^{abc}, (8, 8, 8)."""
    return _const(_D_ABC, dtype, device)


# ---------------------------------------------------------------------------
# Structure-constant contractions and adjoint representations
# ---------------------------------------------------------------------------
def su3fabc(v: torch.Tensor) -> torch.Tensor:
    """f^{abc} v[..., c] -> (..., 8, 8) (utils.py:409-451)."""
    return torch.einsum("abc,...c->...ab", fabc(v.dtype, v.device), v)


def su3dabc(v: torch.Tensor) -> torch.Tensor:
    """d^{abc} v[..., c] -> (..., 8, 8) (utils.py:454-502)."""
    return torch.einsum("abc,...c->...ab", dabc(v.dtype, v.device), v)


def SU3Ad(x: torch.Tensor) -> torch.Tensor:
    """Adjoint rep of a group element: X T^c X† = T^b AdX^{bc},
    AdX^{bc} = -2 tr[T^b X T^c X†] -> (..., 8, 8) real (utils.py:505-517).
    """
    t = su3gen(x.dtype, x.device)
    # y^c = X T^c X†  -> coords via su3_to_vec (batched over c)
    y = torch.einsum("...ik,ckl,...jl->...cij", x, t, x.conj())
    return torch.movedim(g.su3_to_vec(y), -2, -1)


def su3ad(x: torch.Tensor) -> torch.Tensor:
    """Adjoint rep of an algebra element: adX^{ab} = -f^{abc} X^c
    (utils.py:520-525). x is a TAH matrix (..., 3, 3)."""
    return su3fabc(-g.su3_to_vec(x))


def su3adapply(adx: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """adX(Y) = [X, Y] through the adjoint rep: vec_to_su3(adx @ vec(y))
    (utils.py:528-541)."""
    v = torch.einsum("...ab,...b->...a", adx, g.su3_to_vec(y))
    return g.vec_to_su3(v)


# ---------------------------------------------------------------------------
# Exact derivative machinery (utils.py:624-719)
# ---------------------------------------------------------------------------
def diffprojectTAH(m: torch.Tensor,
                   p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d_c projectTAH(M)^a = -tr[T^a (T^c M + M† T^c)] -> (..., 8, 8)
    (utils.py:624-656):
        -1/2 { d^{acb} tr[T^b i(M+M†)] - 1/3 d_ac tr(M+M†) + adP^{ac} }
    evaluated as  su3dabc(vec(i(M+M†))/4) + Re tr(M+M†)/6 I + ad(-P/2).
    """
    if p is None:
        p = g.projectTAH(m)
    ms = m + g.adjoint(m)
    half_ad_p = su3ad(-0.5 * p)
    tr_ms = torch.real(g.trace(ms)) / 6.0
    dterm = su3dabc(0.25 * g.su3_to_vec(1.0j * ms))
    eye8 = torch.eye(8, dtype=dterm.dtype, device=dterm.device)
    return dterm + tr_ms[..., None, None] * eye8 + half_ad_p


def diffprojectTAHCross(m: torch.Tensor, x: Optional[torch.Tensor] = None,
                        Adx: Optional[torch.Tensor] = None,
                        p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """grad_c projectTAH(X Y)^a where the derivative is on Y: the chain
    rule through the adjoint rep of X (utils.py:659-683)."""
    if Adx is None:
        if x is None:
            raise ValueError("provide x or Adx")
        Adx = SU3Ad(x)
    return torch.einsum("...ab,...bc->...ac", diffprojectTAH(m, p), Adx)


def diffexp(adX: torch.Tensor, order: int = 13) -> torch.Tensor:
    """J(X) = (1 - exp(-adX))/adX = sum_k (-adX)^k/(k+1)!, Horner form
    over the (..., 8, 8) adjoint matrices (utils.py:686-719). Satisfies
    exp(-X) d/dt exp(X(t)) = vec_to_su3(J(adX) @ vec(dX/dt))."""
    m = -adX
    eye8 = torch.eye(8, dtype=m.dtype, device=m.device)
    x = eye8 + m / (order + 1.0)
    for i in range(order, 1, -1):
        x = eye8 + (m @ x) / i
    return x


def su3_gradient(f: Callable[[torch.Tensor], torch.Tensor],
                 x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(f(x), D) with D = T^a d_a f, d_a f = d/dt f(exp(t T^a) x)|_0 — the
    reference's SU3GradientTF (utils.py:722-745) by autograd over the 8
    tangent coordinates."""
    rdt = g.real_dtype(x.dtype)
    with torch.no_grad():
        y = f(x)
    v = torch.zeros(x.shape[:-2] + (8,), dtype=rdt, device=x.device,
                    requires_grad=True)
    with torch.enable_grad():
        z = f(g.expm(g.vec_to_su3(v).to(x.dtype)) @ x.detach())
        (d,) = torch.autograd.grad(torch.sum(torch.real(z)), v)
    return y, d


def su3_jacobian(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                 is_SU3: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(f(x), J) with J^{ac} = d F^a / d v^c for the map through the
    tangent chart v -> f(exp(v^c T^c) x) at v = 0 — the reference's
    SU3JacobianTF (utils.py:768-806) by `torch.func.jacfwd`. x is a single
    (3, 3) matrix; map over batches outside. When is_SU3, the output is
    pulled back to the algebra by F -> F(x) stop-grad-adjoint."""
    rdt = g.real_dtype(x.dtype)
    x0 = x.detach()

    def coords(v):
        z = f(g.expm(g.vec_to_su3(v).to(x.dtype)) @ x0)
        if is_SU3:
            z = z @ g.adjoint(z.detach())
        return g.su3_to_vec(z)

    zeros = torch.zeros((8,), dtype=rdt, device=x.device)
    return f(x), torch.func.jacfwd(coords)(zeros)


# ---------------------------------------------------------------------------
# Closed-form 3x3 log (logm.py:15-77) — general (non-hermitian) matrices
# ---------------------------------------------------------------------------
def charpoly3x3(a: torch.Tensor):
    """det(lambda I - A) = lambda^3 + c2 lambda^2 + c1 lambda + c0,
    returned as (c0, c1, c2) (logm.py:15-32)."""
    tr = g.trace(a)
    tr2 = g.trace(a @ a)
    c0 = -g.det3x3(a)
    c1 = 0.5 * (tr * tr - tr2)
    c2 = -tr
    return c0, c1, c2


def eig3x3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of a general 3x3 complex matrix via Cardano's formula
    -> (..., 3) (logm.py:40-60). No data-dependent branching; like the
    reference, the discriminant sqrt is regularized so clustered
    eigenvalues do not produce 0/0 (exact multiple roots lose accuracy —
    the reference has the same limitation)."""
    c0, c1, c2 = charpoly3x3(a)
    b, c, d = c2, c1, c0
    d0 = b * b - 3.0 * c
    d1 = 2.0 * b ** 3 - 9.0 * b * c + 27.0 * d
    ldisc = torch.sqrt(1e-3 + d1 * d1 - 4.0 * d0 ** 3)
    vp = 0.5 * (d1 + ldisc)
    vm = 0.5 * (d1 - ldisc)
    v = torch.where(torch.abs(vp) > torch.abs(vm), vp, vm)
    croot = v ** (1.0 / 3.0)
    w = cmath.exp(2.0j * math.pi / 3.0)
    lams = []
    for k in range(3):
        wk = torch.tensor(w ** k, dtype=a.dtype, device=a.device)
        lams.append(-(b + wk * croot + d0 / (wk * croot)) / 3.0)
    lam = torch.stack(lams, dim=-1)
    # two Newton polish steps remove the regularization bias (~1e-4)
    # wherever the roots are simple; p'(lam) ~ 0 at multiple roots, where
    # the guarded division leaves the (already best-available) Cardano
    # value in place
    bb = b[..., None]
    cc = c[..., None]
    dd = d[..., None]
    for _ in range(2):
        p = ((lam + bb) * lam + cc) * lam + dd
        dp = (3.0 * lam + 2.0 * bb) * lam + cc
        ok = torch.abs(dp) > 1e-8
        step = torch.where(ok, p / torch.where(ok, dp, torch.ones_like(dp)),
                           torch.zeros_like(p))
        lam = lam - step
    return lam


def log3x3(x: torch.Tensor) -> torch.Tensor:
    """Principal log of a 3x3 matrix by Lagrange matrix interpolation on
    its eigenvalues (logm.py:63-77 computes the same polynomial through a
    Vandermonde solve):
        log X = sum_k log(lam_k) prod_{j != k} (X - lam_j I)/(lam_k - lam_j)
    Exact for diagonalizable X; eigenvalue clustering degrades it the
    same way it does the reference's solve (which regularizes with 1e-6).
    """
    lam = eig3x3(x)
    eye = g.eye_of(x)
    out = torch.zeros_like(x)
    eps = 1e-6
    for k in range(3):
        j1, j2 = (k + 1) % 3, (k + 2) % 3
        lk = lam[..., k, None, None]
        l1 = lam[..., j1, None, None]
        l2 = lam[..., j2, None, None]
        num = (x - l1 * eye) @ (x - l2 * eye)
        den = (lk - l1) * (lk - l2) + eps
        out = out + torch.log(lk) * num / den
    return out


# ---------------------------------------------------------------------------
# SUN manifold ops (sun.py:22-56)
# ---------------------------------------------------------------------------
def sun_exp(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Riemannian exp: x @ expm(x† u) (sun.py:26-27)."""
    return x @ g.expm(g.adjoint(x) @ u)


def sun_log(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Riemannian log: x @ log3x3(x† y) (sun.py:29-32)."""
    return x @ log3x3(g.adjoint(x) @ y)


def sun_proju(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Project an ambient tangent u at x to the Lie algebra: traceless
    skew-hermitian part of x† u (sun.py:34-56; the reference computes
    torch.linalg.solve(u, x) = u^{-1} x, which contradicts its own
    `X^{-1} u` docstring — x† u = x^{-1} u for unitary x is used here)."""
    b = g.adjoint(x) @ u
    b = 0.5 * (b - g.adjoint(b))
    nc = x.shape[-1]
    return b - (g.trace(b) / nc)[..., None, None] * g.eye_of(x)


# ---------------------------------------------------------------------------
# Near-identity random elements (generators.py:18-55)
# ---------------------------------------------------------------------------
def random_SU2(generator: Optional[torch.Generator], eps: float,
               batch: Sequence[int] = (), dtype=torch.complex128,
               device=None, draws: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Random SU(2) at distance ~eps from the identity
    (generators.py:18-31): r0 = sqrt(1-eps^2), |r_vec| = eps scaled by
    uniform directions; element = r0 I + i r_vec . sigma. `draws` is the
    (*batch, 3) uniforms on [0, 0.5) that replace the generator."""
    rdt = g.real_dtype(dtype)
    batch = tuple(batch)
    if draws is None:
        draws = 0.5 * torch.rand(batch + (3,), generator=generator,
                                 dtype=rdt, device=device)
    r = draws.to(rdt)
    r = eps * r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    # the reference takes sign(uniform(0, 0.5)) — always +1, keeping the
    # element near +identity (generators.py:23-24)
    r0 = torch.full(batch, math.sqrt(1.0 - eps * eps), dtype=rdt,
                    device=r.device)
    row0 = torch.stack([torch.complex(r0, r[..., 2]),
                        torch.complex(r[..., 1], r[..., 0])], dim=-1)
    row1 = torch.stack([torch.complex(-r[..., 1], r[..., 0]),
                        torch.complex(r0, -r[..., 2])], dim=-1)
    return torch.stack([row0, row1], dim=-2).to(dtype)


def random_SU3(generator: Optional[torch.Generator], eps: float,
               batch: Sequence[int] = (), dtype=torch.complex128,
               device=None, draws: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """Random SU(3) near the identity from three embedded SU(2) subgroup
    elements R S T (generators.py:34-44). `draws` is the three SU(2)
    elements' uniforms (random_SU2's `draws`), in the order R, S, T."""
    batch = tuple(batch)
    draws = draws if draws is not None else (None, None, None)
    su2 = [random_SU2(generator, eps, batch, dtype, device, d) for d in draws]
    dev = su2[0].device
    eye = torch.eye(3, dtype=dtype, device=dev).expand(batch + (3, 3))
    r, s, t = eye.clone(), eye.clone(), eye.clone()
    r[..., :2, :2] = su2[0]
    s[..., ::2, ::2] = su2[1]
    t[..., 1:, 1:] = su2[2]
    return r @ s @ t


def random_SU3_array(generator: Optional[torch.Generator], n: int,
                     eps: float, dtype=torch.complex128, device=None,
                     draws: Optional[Sequence[torch.Tensor]] = None
                     ) -> torch.Tensor:
    """(2n, 3, 3) array of near-identity SU(3) elements interleaved with
    their adjoints (generators.py:47-55)."""
    m = random_SU3(generator, eps, (n,), dtype, device, draws)
    out = torch.stack([m, g.adjoint(m)], dim=1)
    return out.reshape(2 * n, 3, 3)
