"""SU(3) group + su(3) algebra numerics on complex (..., 3, 3) tensors.

PyTorch counterpart of the JAX package's `ops/su3.py` (after the
reference's SU3 group stack, src/l2hmc/group/su3/pytorch/group.py:36-227
and group/su3/pytorch/utils.py). All functions are batched over arbitrary
leading dims (matrices occupy the last two axes) and follow the dtype of
their input: complex128 for parity-grade numerics, complex64 for speed.

* momenta live in the algebra su(3): 3x3 traceless anti-hermitian (TAH)
  matrices, 8 real dof per link, Gaussian with the normalization of the
  reference's `randTAH3` (utils.py:171-195)
* `expm` is a scaling-and-squaring 12th-order Taylor series (utils.py:148-154
  plus squaring for robustness at larger norms)
* `projectSU` = polar projection x (x†x)^{-1/2} with a closed-form 3x3
  inverse square root via characteristic-polynomial eigenvalues
  (utils.py:227-346), then a det-phase fix into SU(3)

Random draws take a `torch.Generator`, or the Gaussian draws themselves.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

NAME = "SU3"
DIM = 4

SQRT1BY2 = math.sqrt(1.0 / 2.0)
SQRT1BY3 = math.sqrt(1.0 / 3.0)
SQRT3 = math.sqrt(3.0)
ONE_THIRD = 1.0 / 3.0


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 for complex64, float64 for complex128; real dtypes as is."""
    return torch.empty((), dtype=dtype).real.dtype


def eye_of(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)


def mul(a, b, adjoint_a=False, adjoint_b=False):
    """Batched matrix product with optional adjoints (group.py:58-71)."""
    if adjoint_a:
        a = adjoint(a)
    if adjoint_b:
        b = adjoint(b)
    return a @ b


def adjoint(x: torch.Tensor) -> torch.Tensor:
    return x.conj().transpose(-2, -1)


def trace(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def det3x3(x: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 determinant (cofactor expansion): exactly
    differentiable, no LU."""
    a, b, c = x[..., 0, 0], x[..., 0, 1], x[..., 0, 2]
    d, e, f = x[..., 1, 0], x[..., 1, 1], x[..., 1, 2]
    g_, h, i = x[..., 2, 0], x[..., 2, 1], x[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g_) + c * (d * h - e * g_)


def norm2(x: torch.Tensor, axis=(-2, -1)) -> torch.Tensor:
    """Frobenius norm squared over `axis` (utils.py:157-168)."""
    n = x.real ** 2 + x.imag ** 2 if x.is_complex() else x ** 2
    if axis is None or len(axis) == 0:
        return n
    return torch.sum(n, dim=tuple(axis))


# ---------------------------------------------------------------------------
# Matrix exponential
# ---------------------------------------------------------------------------
def expm_taylor(m: torch.Tensor, order: int = 12) -> torch.Tensor:
    """Horner-evaluated Taylor series of exp(m) (utils.py:148-154)."""
    eye = eye_of(m)
    x = eye + m / order
    for i in range(order - 1, 0, -1):
        x = eye + (m @ x) / i
    return x


def expm(m: torch.Tensor, order: int = 12, s: int = 4) -> torch.Tensor:
    """exp(m) via scaling-and-squaring around the Taylor core. s=4 handles
    |m|_F up to ~10 at ~1e-10 accuracy; `update_gauge`'s s=2 is exact to
    ~1e-12 for |m|_F < 3."""
    x = expm_taylor(m / (2 ** s), order=order)
    for _ in range(s):
        x = x @ x
    return x


def update_gauge(x: torch.Tensor, p: torch.Tensor, s: int = 2) -> torch.Tensor:
    """x <- exp(p) x (group.py:45-50)."""
    return expm(p, s=s) @ x


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def projectTAH(x: torch.Tensor) -> torch.Tensor:
    """Traceless anti-hermitian projection (group.py:92-103):
    R = (x - x†)/2 - tr(x - x†)/(2 Nc) · I"""
    nc = x.shape[-1]
    r = 0.5 * (x - adjoint(x))
    d = trace(r) / nc
    return r - d[..., None, None] * eye_of(x)


def eigs3x3(tr: torch.Tensor, p2: torch.Tensor, det: torch.Tensor):
    """Eigenvalues of a 3x3 hermitian matrix from char-poly invariants
    (trace, tr(x^2), det — all real): the trigonometric (Cardano) solution
    with the clamps of the reference (utils.py:227-283).

    q is floored at eps^1.5 of the dtype: at an exactly degenerate
    spectrum q == 0 and sqrt's backward is 1/0. Below the floor the
    eigenvalue splitting is unresolvable at this precision anyway; eps^1.5
    (not eps^2) keeps the backward's q^-3 inside the dtype's range."""
    fi = torch.finfo(tr.dtype)
    tr3 = ONE_THIRD * tr
    p23 = ONE_THIRD * p2
    tr32 = tr3 * tr3
    q = torch.clamp(torch.abs(0.5 * (p23 - tr32)),
                    min=fi.eps * math.sqrt(fi.eps))
    r = 0.25 * tr3 * (5.0 * tr32 - p2) - 0.5 * det
    sq = torch.sqrt(q)
    sq3 = q * sq
    isq3 = 1.0 / torch.clamp(sq3, min=fi.tiny)
    isq3 = torch.clamp(isq3, -3e38, 3e38)
    rsq3 = torch.clamp(r * isq3, -1.0 + fi.eps, 1.0 - fi.eps)
    t = ONE_THIRD * torch.acos(rsq3)
    st = torch.sin(t)
    ct = torch.cos(t)
    sqc = sq * ct
    sqs = SQRT3 * sq * st
    ll = tr3 + sqc
    e0 = tr3 - 2.0 * sqc
    e1 = ll + sqs
    e2 = ll - sqs
    return e0, e1, e2


def _rsqrtPHM3f(tr, p2, det):
    """Coefficients (c0, c1, c2) with x^{-1/2} = c0 I + c1 x + c2 x^2
    for positive-definite hermitian x (utils.py:286-317)."""
    e0, e1, e2 = eigs3x3(tr, p2, det)
    se0 = torch.sqrt(torch.abs(e0))
    se1 = torch.sqrt(torch.abs(e1))
    se2 = torch.sqrt(torch.abs(e2))
    u = se0 + se1 + se2
    w = se0 * se1 * se2
    d = w * (se0 + se1) * (se0 + se2) * (se1 + se2)
    di = 1.0 / d
    c0 = di * (
        w * u * u
        + e0 * se0 * (e1 + e2)
        + e1 * se1 * (e0 + e2)
        + e2 * se2 * (e0 + e1)
    )
    c1 = -(tr * u + w) * di
    c2 = u * di
    return c0, c1, c2


def rsqrtPHM3(x: torch.Tensor) -> torch.Tensor:
    """(hermitian positive x)^{-1/2} in closed form (utils.py:320-329)."""
    tr = trace(x).real
    x2 = x @ x
    p2 = trace(x2).real
    det = det3x3(x).real
    c0, c1, c2 = _rsqrtPHM3f(tr, p2, det)

    def cast(c):
        return c[..., None, None].to(x.dtype)
    return cast(c0) * eye_of(x) + cast(c1) * x + cast(c2) * x2


def projectU(x: torch.Tensor) -> torch.Tensor:
    """Polar projection onto U(3): x (x†x)^{-1/2} (utils.py:332-338)."""
    t = adjoint(x) @ x
    return x @ rsqrtPHM3(t)


def projectSU(x: torch.Tensor) -> torch.Tensor:
    """projectU then rotate the det phase to land in SU(3)
    (utils.py:341-346)."""
    nc = x.shape[-1]
    m = projectU(x)
    d = det3x3(m)
    p = torch.atan2(d.imag, d.real) / (-nc)
    phase = torch.complex(torch.cos(p), torch.sin(p)).to(x.dtype)
    return m * phase[..., None, None]


compat_proj = projectSU


# ---------------------------------------------------------------------------
# Unitarity monitors (utils.py:362-391)
# ---------------------------------------------------------------------------
def _deviation(d: torch.Tensor, nc: int):
    d = d.reshape(d.shape[0], -1)
    c = 2.0 * (nc * nc + 1.0)
    return (torch.sqrt(torch.mean(d, dim=-1) / c),
            torch.sqrt(torch.amax(d, dim=-1) / c))


def checkU(x: torch.Tensor):
    """(mean, max) deviation of x†x from identity per chain."""
    return _deviation(norm2(adjoint(x) @ x - eye_of(x)), x.shape[-1])


def checkSU(x: torch.Tensor):
    """(mean, max) deviation of x†x from I and det x from 1, per chain."""
    d = norm2(adjoint(x) @ x - eye_of(x))
    d = d + torch.square(torch.abs(det3x3(x) - 1.0))
    return _deviation(d, x.shape[-1])


# ---------------------------------------------------------------------------
# Algebra <-> vector (Gell-Mann coordinates; utils.py:394-445)
# ---------------------------------------------------------------------------
def su3_to_vec(x: torch.Tensor) -> torch.Tensor:
    """TAH matrix -> 8 real components, X^a = -2 tr[T^a X]."""
    c = -2.0
    x00 = x[..., 0, 0]
    x01 = x[..., 0, 1]
    x02 = x[..., 0, 2]
    x11 = x[..., 1, 1]
    x12 = x[..., 1, 2]
    x22 = x[..., 2, 2]
    return torch.stack([
        c * x01.imag,
        c * x01.real,
        x11.imag - x00.imag,
        c * x02.imag,
        c * x02.real,
        c * x12.imag,
        c * x12.real,
        SQRT1BY3 * (2.0 * x22.imag - x11.imag - x00.imag),
    ], dim=-1)


def vec_to_su3(v: torch.Tensor) -> torch.Tensor:
    """8 real components -> TAH matrix, X = X^a T^a."""
    s3 = SQRT1BY3
    c = -0.5
    zero = torch.zeros_like(v[..., 0])
    x01 = c * torch.complex(v[..., 1], v[..., 0])
    x02 = c * torch.complex(v[..., 4], v[..., 3])
    x12 = c * torch.complex(v[..., 6], v[..., 5])
    x2i = s3 * v[..., 7]
    x0i = c * (x2i + v[..., 2])
    x1i = c * (x2i - v[..., 2])
    v00 = torch.complex(zero, x0i)
    v11 = torch.complex(zero, x1i)
    v22 = torch.complex(zero, x2i)
    r0 = torch.stack([v00, x01, x02], dim=-1)
    r1 = torch.stack([-x01.conj(), v11, x12], dim=-1)
    r2 = torch.stack([-x02.conj(), -x12.conj(), v22], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def group_to_vec(x: torch.Tensor) -> torch.Tensor:
    """SU(3)-ish matrix -> 8-vector via projectSU then coords
    (group.py:138-147)."""
    return su3_to_vec(compat_proj(x))


def vec_to_group(x: torch.Tensor) -> torch.Tensor:
    return compat_proj(vec_to_su3(x))


# ---------------------------------------------------------------------------
# Random elements
# ---------------------------------------------------------------------------
def random(shape: Sequence[int], generator: Optional[torch.Generator] = None,
           dtype=torch.complex128, device=None, draws=None) -> torch.Tensor:
    """Haar random SU(3): projectSU of a complex Gaussian (the reference's
    own `random`, group/su3/pytorch/group.py:113-119). Exactly Haar: the
    Ginibre density is invariant under left unitary multiplication, so its
    polar factor carries the left-invariant measure. `draws` = (re, im)
    standard normals of `shape` replaces the generator."""
    rdt = real_dtype(dtype)
    if draws is None:
        draws = tuple(torch.randn(tuple(shape), generator=generator,
                                  dtype=rdt, device=device)
                      for _ in range(2))
    r, i = draws
    return projectSU(torch.complex(r.to(rdt), i.to(rdt)))


def random_momentum(shape: Sequence[int],
                    generator: Optional[torch.Generator] = None,
                    dtype=torch.complex128, device=None,
                    draws=None) -> torch.Tensor:
    """Gaussian TAH momenta with the reference's normalization
    (utils.py:171-195). `shape` includes the trailing (3, 3); `draws` is
    the (8, *shape[:-2]) standard normals in the order r3, r8, r01, r02,
    r12, i01, i02, i12."""
    if tuple(shape[-2:]) != (3, 3):
        raise ValueError(f"momentum shape must end in (3, 3), got {shape}")
    base = tuple(shape[:-2])
    rdt = real_dtype(dtype)
    if draws is None:
        draws = torch.randn((8, *base), generator=generator, dtype=rdt,
                            device=device)
    draws = draws.to(rdt)
    r3 = SQRT1BY2 * draws[0]
    r8 = SQRT1BY2 * SQRT1BY3 * draws[1]
    r01, r02, r12, i01, i02, i12 = (SQRT1BY2 * draws[k] for k in range(2, 8))
    zero = torch.zeros_like(r3)
    m00 = torch.complex(zero, r8 + r3)
    m11 = torch.complex(zero, r8 - r3)
    m22 = torch.complex(zero, -2.0 * r8)
    m01 = torch.complex(r01, i01)
    m02 = torch.complex(r02, i02)
    m12 = torch.complex(r12, i12)
    r0 = torch.stack([m00, m01, m02], dim=-1)
    r1 = torch.stack([-m01.conj(), m11, m12], dim=-1)
    r2 = torch.stack([-m02.conj(), -m12.conj(), m22], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2).to(dtype)


def kinetic_energy(p: torch.Tensor) -> torch.Tensor:
    """KE = 0.5 sum_links (|p|^2 - 8) per chain (group.py:125-126)."""
    n = norm2(p) - 8.0
    return 0.5 * torch.sum(n.reshape(n.shape[0], -1), dim=-1)
