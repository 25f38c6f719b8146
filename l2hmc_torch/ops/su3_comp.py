"""Stacked-component SU(3) engine: a field is a pair of real tensors.

PyTorch counterpart of the JAX package's `ops/su3_comp.py`. A field
(`F3`) is a pair of real tensors `re`, `im` shaped (3, 3, L): the colour
indices lead, and every [i, j] component is one contiguous vector over the
flat link batch L. Elementwise work then coalesces along L on the card,
and keeping real pairs keeps autograd out of complex-derivative
conventions. The 3x3 algebra unrolls only the k-contraction (three
broadcast multiply-adds per re/im), as the reference does.

A lattice field has L = 4 * V * nb in the flat order (d, t, x, y, z, nb),
the order the reference's engine uses, so `Dynamics._vec_flatten` /
`_stq_to_comp` keep their feature order and weights convert one to one.
The reference folds L to (L // 128, 128) to fill a vector tile; that fold
is a layout device of its target and has no counterpart here.

Lattice neighbour access reshapes L to (pre, L_axis, post), rolls, and
reshapes back. Per-direction sub-fields are colour-preserving slices.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from l2hmc_torch.ops.kernels import su3_force, su3_link
from l2hmc_torch.utils import spans

SQRT1BY3 = math.sqrt(1.0 / 3.0)


class F3(NamedTuple):
    """Stacked-component 3x3 complex field: re/im each (3, 3, L)."""
    re: torch.Tensor
    im: torch.Tensor

    @property
    def batch(self):
        return tuple(self.re.shape[2:])


def batch_size(f: F3) -> int:
    return int(math.prod(f.batch)) if f.batch else 1


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------
def from_complex_lattice(x: torch.Tensor) -> F3:
    """(nb, 4, t, x, y, z, 3, 3) complex -> F3 with the flat batch in
    (d, t, x, y, z, nb) order."""
    nd = x.ndim
    # (nb, d, lat..., i, j) -> (i, j, d, lat..., nb)
    perm = (nd - 2, nd - 1) + tuple(range(1, nd - 2)) + (0,)
    xt = x.permute(perm)
    return F3(xt.real.reshape(3, 3, -1), xt.imag.reshape(3, 3, -1))


def to_complex_lattice(f: F3, lat, nb: int, dtype) -> torch.Tensor:
    """Inverse of from_complex_lattice."""
    shape = (3, 3, 4, *lat, nb)
    m = torch.complex(f.re.reshape(shape), f.im.reshape(shape)).to(dtype)
    nd = m.ndim
    # (i, j, d, lat..., nb) -> (nb, d, lat..., i, j)
    perm = (nd - 1,) + tuple(range(2, nd - 1)) + (0, 1)
    return m.permute(perm)


# ---------------------------------------------------------------------------
# Basic algebra
# ---------------------------------------------------------------------------
def mm(a: F3, b: F3, adj_a: bool = False, adj_b: bool = False) -> F3:
    """op(a) @ op(b) with only the k-contraction unrolled: three
    (3, 1, L) x (1, 3, L) broadcast multiply-adds per re/im. The
    conjugations of the adjoints are folded into the signs of the four
    products."""
    cr = None
    ci = None
    for k in range(3):
        if adj_a:
            ar, ai = a.re[k, :, None], a.im[k, :, None]
        else:
            ar, ai = a.re[:, k, None], a.im[:, k, None]
        if adj_b:
            br, bi = b.re[None, :, k], b.im[None, :, k]
        else:
            br, bi = b.re[None, k, :], b.im[None, k, :]
        p = ar * br
        q = ai * bi
        r = ar * bi
        t = ai * br
        tr = p + q if (adj_a != adj_b) else p - q
        if adj_a and adj_b:
            ti = -(r + t)
        elif adj_a:
            ti = r - t
        elif adj_b:
            ti = t - r
        else:
            ti = r + t
        cr = tr if cr is None else cr + tr
        ci = ti if ci is None else ci + ti
    return F3(cr, ci)


def _swapT(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(0, 1)


def trace_mm(a: F3, b: F3, adj_a: bool = False, adj_b: bool = False):
    """(Re, Im) of tr[op(a) op(b)]: an elementwise contraction over both
    colour axes (sum_ik op(a)[i,k] op(b)[k,i])."""
    if adj_a:
        ar, ai = _swapT(a.re), -_swapT(a.im)
    else:
        ar, ai = a.re, a.im
    # op(b)[k,i] aligned with a's [i,k]: transpose unless adjoint
    if adj_b:
        br, bi = b.re, -b.im
    else:
        br, bi = _swapT(b.re), _swapT(b.im)
    sr = torch.sum(ar * br - ai * bi, dim=(0, 1))
    si = torch.sum(ar * bi + ai * br, dim=(0, 1))
    return sr, si


def adjoint(a: F3) -> F3:
    return F3(_swapT(a.re), -_swapT(a.im))


def add(a: F3, b: F3) -> F3:
    return F3(a.re + b.re, a.im + b.im)


def scale(a: F3, s) -> F3:
    return F3(s * a.re, s * a.im)


def _eye3(a: torch.Tensor) -> torch.Tensor:
    """(3, 3, 1...) identity broadcastable against a (3, 3, *B) tensor."""
    return torch.eye(3, dtype=a.dtype, device=a.device).reshape(
        3, 3, *([1] * (a.ndim - 2)))


def trace(a: F3):
    return (a.re[0, 0] + a.re[1, 1] + a.re[2, 2],
            a.im[0, 0] + a.im[1, 1] + a.im[2, 2])


def norm2(a: F3):
    return torch.sum(a.re * a.re + a.im * a.im, dim=(0, 1))


def eye_like(a: F3) -> F3:
    e = _eye3(a.re).expand(a.re.shape).clone()
    return F3(e, torch.zeros_like(a.re))


def projectTAH(x: F3) -> F3:
    """0.5 (x - x†) - (tr Im / 3) I (reference
    group/su3/pytorch/group.py:92-103)."""
    zr = 0.5 * (x.re - _swapT(x.re))
    zi = 0.5 * (x.im + _swapT(x.im))
    tim = (zi[0, 0] + zi[1, 1] + zi[2, 2]) / 3.0
    zi = zi - tim * _eye3(zi)
    return F3(zr, zi)


EXPM = spans.span("su3.expm")


def expm(m: F3, order: int = 12, s: int = 2) -> F3:
    """Scaling-squaring Taylor (Horner): the reference's order-12 Taylor
    (group/su3/pytorch/utils.py:148-154) plus 2^-s scaling.

    The recurrence and the squarings run on y = exp(m) - 1 and the 1 is
    added once, at the end: x_i = 1 + m x_(i+1) / i is y_i = (m + m
    y_(i+1)) / i, and (1 + y)^2 = 1 + (2 y + y^2). Rounding 1 + y at every
    step, as the plain Horner form does, drops the low bits of the small
    terms: in float32 at the records' step sizes that shrank the links
    by ~2e-8 of tr(U^dag U)/3 a call, with one sign, so HMC drifted off
    SU(3) and raised the action (an XLA-fused multiply-add rounds less).
    (A span inside the body, not a decorator around it: a decorator's
    frame would hold the caller's m through the call.)

    On the card, where no gradient can be asked of the call, one launch of
    the hand-written kernel (ops/kernels/su3_link.py) computes the same
    recurrence; everywhere else this body does, unchanged."""
    with EXPM:
        if _no_grad_on_card(m):
            return F3(*su3_link.expm(m.re, m.im, order, s))
        m = scale(m, 1.0 / (2 ** s))
        y = F3(m.re / order, m.im / order)
        for i in range(order - 1, 0, -1):
            p = mm(m, y)
            y = F3((m.re + p.re) / i, (m.im + p.im) / i)
        for _ in range(s):
            p = mm(y, y)
            y = F3(2.0 * y.re + p.re, 2.0 * y.im + p.im)
        return F3(_eye3(m.re) + y.re, y.im)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def det3x3(x: F3):
    def c(i, j):
        return x.re[i, j], x.im[i, j]

    def minor(i0, i1, j0, j1):
        p0 = _cmul(*c(i0, j0), *c(i1, j1))
        p1 = _cmul(*c(i0, j1), *c(i1, j0))
        return p0[0] - p1[0], p0[1] - p1[1]

    m0 = minor(1, 2, 1, 2)
    m1 = minor(1, 2, 0, 2)
    m2 = minor(1, 2, 0, 1)
    t0 = _cmul(*c(0, 0), *m0)
    t1 = _cmul(*c(0, 1), *m1)
    t2 = _cmul(*c(0, 2), *m2)
    return t0[0] - t1[0] + t2[0], t0[1] - t1[1] + t2[1]


def rsqrtPHM3(t: F3) -> F3:
    """(x†x)^(-1/2) via the closed-form char-poly chain (reference
    group/su3/pytorch/utils.py:227-329)."""
    from l2hmc_torch.ops.su3 import _rsqrtPHM3f
    tr = t.re[0, 0] + t.re[1, 1] + t.re[2, 2]
    t2 = mm(t, t)
    p2 = t2.re[0, 0] + t2.re[1, 1] + t2.re[2, 2]
    det_re, _ = det3x3(t)
    c0, c1, c2 = _rsqrtPHM3f(tr, p2, det_re)
    e = _eye3(t.re)
    return F3(c0 * e + c1 * t.re + c2 * t2.re, c1 * t.im + c2 * t2.im)


def _fix_det_phase(m: F3) -> F3:
    """m * det(m)^(-1/3) phase: rotates a unitary m into SU(3)."""
    dre, dim = det3x3(m)
    p = torch.atan2(dim, dre) / (-3.0)
    cr, ci = torch.cos(p), torch.sin(p)
    return F3(m.re * cr - m.im * ci, m.re * ci + m.im * cr)


def projectSU(x: F3) -> F3:
    """x (x†x)^(-1/2) det-phase-fixed (utils.py:341-346). For rough
    inputs (random sampling); its backward divides by zero at x†x = I, so
    it never sits on a gradient path (see `reunit`)."""
    t = mm(x, x, adj_a=True)
    return _fix_det_phase(mm(x, rsqrtPHM3(t)))


@spans.span("su3.reunit")
def reunit(x: F3) -> F3:
    """Differentiable reunitarization x (x†x)^{-1/2}, det-phase-fixed,
    for NEAR-UNITARY x (spectral radius of x†x - I below 1).

    The same map as projectSU with another parametrization of the inverse
    square root. projectSU's closed-form eigendecomposition has an exactly
    degenerate spectrum at x†x = I, where sqrt(q)'s backward divides by
    zero: on production-size batches some link always rounds q to exactly
    0 and one NaN poisons the whole training gradient. Newton-Schulz for
    the inverse square root is a matmul polynomial in t = x†x:
    quadratically convergent for ||t - I|| < 1 and smooth at the
    degenerate point, so the backward is exact and finite everywhere in
    its domain. Three iterations reach float32 machine precision from
    ||t - I|| <~ 0.1; the drift-correction call sites sit at ~1e-6.

    On the card, where no gradient can be asked of the call, one launch of
    the hand-written kernel (ops/kernels/su3_link.py) computes the same
    map; everywhere else this body does, unchanged."""
    if _no_grad_on_card(x):
        return F3(*su3_link.reunit(x.re, x.im))
    t = mm(x, x, adj_a=True)
    e = _eye3(t.re)
    y = F3(e.expand(t.re.shape), torch.zeros_like(t.re))
    for _ in range(3):
        # y <- y (3I - t y^2)/2; every iterate is a polynomial in the
        # hermitian t, so all factors commute and ordering is free
        ty2 = mm(t, mm(y, y))
        z = F3(1.5 * e - 0.5 * ty2.re, -0.5 * ty2.im)
        y = mm(y, z)
    return _fix_det_phase(mm(x, y))


def su3_to_vec(x: F3) -> torch.Tensor:
    """(8, L) Gell-Mann coordinates, the convention of ops/su3.su3_to_vec
    (group/su3/pytorch/utils.py:394-420)."""
    c = -2.0
    return torch.stack([
        c * x.im[0, 1],
        c * x.re[0, 1],
        x.im[1, 1] - x.im[0, 0],
        c * x.im[0, 2],
        c * x.re[0, 2],
        c * x.im[1, 2],
        c * x.re[1, 2],
        SQRT1BY3 * (2.0 * x.im[2, 2] - x.im[1, 1] - x.im[0, 0]),
    ])


def random_momentum(n: int, generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device=None, draws=None) -> F3:
    """Gaussian TAH momenta for n links (reference utils.py:171-195);
    `draws` is the (8, n) standard normals in the order r3, r8, r01, r02,
    r12, i01, i02, i12."""
    s2 = math.sqrt(0.5)
    if draws is None:
        draws = torch.randn((8, int(n)), generator=generator, dtype=dtype,
                            device=device)
    r3 = s2 * draws[0]
    r8 = s2 * SQRT1BY3 * draws[1]
    r01, r02, r12, i01, i02, i12 = (s2 * draws[k] for k in range(2, 8))
    zero = torch.zeros_like(r3)
    re = torch.stack([
        torch.stack([zero, r01, r02]),
        torch.stack([-r01, zero, r12]),
        torch.stack([-r02, -r12, zero]),
    ])
    im = torch.stack([
        torch.stack([r8 + r3, i01, i02]),
        torch.stack([i01, r8 - r3, i12]),
        torch.stack([i02, i12, -2.0 * r8]),
    ])
    return F3(re, im)


# ---------------------------------------------------------------------------
# Lattice fields: L = 4 * V * nb, flat order (d, t, x, y, z, nb)
# ---------------------------------------------------------------------------
def make_roll(lat: Sequence[int], nb: int):
    """Roll a per-direction field (L = V * nb) along lattice axis 0..3 via
    reshapes around a torch.roll. The closure's `periodic` attribute,
    (lat, nb), marks it as the engine's own periodic roll."""
    lat = tuple(int(n) for n in lat)

    def roll(a: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
        pre = math.prod(lat[:axis])
        post = math.prod(lat[axis + 1:]) * nb
        v = a.reshape(3, 3, pre, lat[axis], post)
        return torch.roll(v, shift, dims=3).reshape(a.shape)

    roll.periodic = (lat, int(nb))
    return roll


def roll_f(f: F3, shift: int, axis: int, roll) -> F3:
    return F3(roll(f.re, shift, axis), roll(f.im, shift, axis))


def dir_slice(x: F3, u: int, n_dir: int) -> F3:
    """Direction u of a 4-direction field -> (3, 3, n_dir)."""
    return F3(x.re.reshape(3, 3, 4, n_dir)[:, :, u],
              x.im.reshape(3, 3, 4, n_dir)[:, :, u])


def stack_dirs(fs) -> F3:
    return F3(torch.stack([f.re for f in fs], dim=2).reshape(3, 3, -1),
              torch.stack([f.im for f in fs], dim=2).reshape(3, 3, -1))


def _n_dir(lat, nb: int) -> int:
    return math.prod(int(n) for n in lat) * nb


def plaq_traces(x: F3, lat, nb: int, roll=None, per_plane: bool = False):
    """Plaquette traces; (V*nb,)-flat (Re, Im) tensors (or lists of 6)."""
    if roll is None:
        roll = make_roll(lat, nb)
    n_dir = _n_dir(lat, nb)
    res, ims = [], []
    for u in range(1, 4):
        for v in range(0, u):
            xu = dir_slice(x, u, n_dir)
            xv = dir_slice(x, v, n_dir)
            yuv = mm(xu, roll_f(xv, -1, u, roll))
            yvu = mm(xv, roll_f(xu, -1, v, roll))
            tr_re, tr_im = trace_mm(yuv, yvu, adj_b=True)
            res.append(tr_re)
            ims.append(tr_im)
    if per_plane:
        return res, ims
    return sum(res[1:], res[0]), sum(ims[1:], ims[0])


def rect_traces(x: F3, lat, nb: int, roll=None):
    """Re parts of the two 2x1 rectangle traces per (u, v) plane: 12 flat
    (V*nb,) tensors (reference lattice/su3/pytorch/lattice.py:180-195
    builds the same loops)."""
    if roll is None:
        roll = make_roll(lat, nb)
    n_dir = _n_dir(lat, nb)
    out = []
    for u in range(1, 4):
        for v in range(0, u):
            xu = dir_slice(x, u, n_dir)
            xv = dir_slice(x, v, n_dir)
            yuv = mm(xu, roll_f(xv, -1, u, roll))
            yvu = mm(xv, roll_f(xu, -1, v, roll))
            yu = roll_f(xu, -1, v, roll)
            yv = roll_f(xv, -1, u, roll)
            uu = mm(xv, yuv, adj_a=True)
            ur = mm(xu, yvu, adj_a=True)
            ul = mm(yuv, yu, adj_b=True)
            ud = mm(yvu, yv, adj_b=True)
            ul_ = roll_f(ul, -1, u, roll)
            ud_ = roll_f(ud, -1, v, roll)
            out.append(trace_mm(ur, ul_, adj_b=True)[0])
            out.append(trace_mm(uu, ud_, adj_b=True)[0])
    return out


def _chain_sum(a: torch.Tensor, nb: int) -> torch.Tensor:
    """Flat (sites*nb,) -> per-chain sum (nb,)."""
    return a.reshape(-1, nb).sum(dim=0)


def clover_field(x: F3, lat, nb: int, roll=None):
    """Clover-averaged field strength: one traceless anti-hermitian F3
    per (u, v) plane (u > v, plaq_traces plane order), T_uv =
    projectTAH(sum of the 4 clover leaves).

    The reference's SU(3) integer charge is a TODO stub (the plaquette
    imag-trace, lattice/su3/pytorch/lattice.py:232-235); the clover charge
    is the standard field-theoretic definition the stub stands in for."""
    if roll is None:
        roll = make_roll(lat, nb)
    n_dir = _n_dir(lat, nb)
    out = []
    for u in range(1, 4):
        for v in range(0, u):
            xu = dir_slice(x, u, n_dir)
            xv = dir_slice(x, v, n_dir)
            xv_pu = roll_f(xv, -1, u, roll)        # U_v(n+u)
            xu_pv = roll_f(xu, -1, v, roll)        # U_u(n+v)
            # Q1 = U_u(n) U_v(n+u) U_u(n+v)^ U_v(n)^
            q1 = mm(mm(xu, xv_pu), mm(xv, xu_pv), adj_b=True)
            xu_mu = roll_f(xu, 1, u, roll)         # U_u(n-u)
            xv_mu = roll_f(xv, 1, u, roll)         # U_v(n-u)
            xu_mu_pv = roll_f(xu_mu, -1, v, roll)  # U_u(n-u+v)
            # Q2 = U_v(n) U_u(n-u+v)^ U_v(n-u)^ U_u(n-u)
            q2 = mm(mm(xv, xu_mu_pv, adj_b=True),
                    mm(xv_mu, xu_mu, adj_a=True))
            xv_mv = roll_f(xv, 1, v, roll)         # U_v(n-v)
            xu_mv = roll_f(xu, 1, v, roll)         # U_u(n-v)
            xv_mu_mv = roll_f(xv_mu, 1, v, roll)   # U_v(n-u-v)
            xu_mu_mv = roll_f(xu_mu, 1, v, roll)   # U_u(n-u-v)
            # Q3 = U_u(n-u)^ U_v(n-u-v)^ U_u(n-u-v) U_v(n-v)
            q3 = mm(mm(xu_mu, xv_mu_mv, adj_a=True, adj_b=True),
                    mm(xu_mu_mv, xv_mv))
            xv_pu_mv = roll_f(xv_pu, 1, v, roll)   # U_v(n+u-v)
            # Q4 = U_v(n-v)^ U_u(n-v) U_v(n+u-v) U_u(n)^
            q4 = mm(mm(xv_mv, xu_mv, adj_a=True),
                    mm(xv_pu_mv, xu, adj_b=True))
            c = add(add(q1, q2), add(q3, q4))
            out.append(projectTAH(c))
    return out


def topo_charge_clover(x: F3, lat, nb: int, roll=None) -> torch.Tensor:
    """Per-chain topological charge Q = (1/32 pi^2) sum_x
    eps_{uvrs} tr[F_uv F_rs] with clover-averaged F = -(i/4) T_uv
    (T from clover_field)."""
    t10, t20, t21, t30, t31, t32 = clover_field(x, lat, nb, roll)
    q = (trace_mm(t10, t32)[0] - trace_mm(t20, t31)[0]
         + trace_mm(t30, t21)[0])
    dens = -(1.0 / (64.0 * math.pi ** 2)) * q
    return _chain_sum(dens, nb)


def action(x: F3, beta, lat, nb: int, roll=None,
           c1: float = 0.0) -> torch.Tensor:
    """Wilson (c1=0) or improved (DBW2/Iwasaki, c1 != 0) gauge action:
    S = -(1/3)[beta(1-8c1) sum Re tr P + beta c1 sum Re tr R]
    (lattice/su3/pytorch/lattice.py:252-269, arXiv hep-lat/0512017)."""
    re_tot, _ = plaq_traces(x, lat, nb, roll)
    s = (1.0 - 8.0 * c1) * _chain_sum(re_tot, nb)
    if c1 != 0.0:
        r = 0.0
        for tr in rect_traces(x, lat, nb, roll):
            r = r + _chain_sum(tr, nb)
        s = s + c1 * r
    return (-beta / 3.0) * s


def kinetic_energy(v: F3, nb: int) -> torch.Tensor:
    return 0.5 * _chain_sum(norm2(v) - 8.0, nb)


def staples(x: F3, lat, nb: int, roll=None) -> F3:
    if roll is None:
        roll = make_roll(lat, nb)
    n_dir = _n_dir(lat, nb)
    outs = []
    for u in range(4):
        xu = dir_slice(x, u, n_dir)
        acc = None
        for v in range(4):
            if v == u:
                continue
            xv = dir_slice(x, v, n_dir)
            xv_pu = roll_f(xv, -1, u, roll)
            xu_pv = roll_f(xu, -1, v, roll)
            up = mm(mm(xv_pu, xu_pv, adj_b=True), xv, adj_b=True)
            xv_mv = roll_f(xv, 1, v, roll)
            xu_mv = roll_f(xu, 1, v, roll)
            xv_pu_mv = roll_f(xv_mv, -1, u, roll)
            down = mm(mm(xv_pu_mv, xu_mv, adj_a=True, adj_b=True), xv_mv)
            contrib = add(up, down)
            acc = contrib if acc is None else add(acc, contrib)
        outs.append(acc)
    return stack_dirs(outs)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _no_grad_on_card(x: F3, *more) -> bool:
    """Whether a CUDA kernel of the engine may take x: it lies on the card
    in float32 or float64, and no autograd graph can be recorded through
    the call (neither x nor a tensor of `more` wants a gradient)."""
    if not (_on_card(x.re) and _on_card(x.im)
            and x.re.dtype in (torch.float32, torch.float64)):
        return False
    wants = [t for t in (x.re, x.im, *more) if isinstance(t, torch.Tensor)]
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in wants))


def _kernel_takes(x: F3, beta, lat, nb: int, roll) -> bool:
    """Whether `force_and_traces` goes to the CUDA kernel: `_no_grad_on_card`
    of the links and beta, and the roll is the engine's own periodic one."""
    if not _no_grad_on_card(x, beta):
        return False
    return roll is None or getattr(roll, "periodic", None) == (
        tuple(int(n) for n in lat), int(nb))


@spans.span("su3.force_and_traces")
def force_and_traces(x: F3, beta, lat, nb: int, roll=None):
    """(force, plaq_re_sum per chain) for the Wilson action.

    On the card, where no gradient can be asked of the call and `roll` is
    None or the engine's own periodic roll (`make_roll`), one launch of
    the hand-written kernel (ops/kernels/su3_force.py) computes both;
    everywhere else (the CPU, a differentiated call, a foreign roll such
    as parallel/halo.py's) `force_and_traces_plain` does, unchanged."""
    if _kernel_takes(x, beta, lat, nb, roll):
        re, im = x
        if su3_force.pitch(re, im) is None:
            re, im = re.contiguous(), im.contiguous()
        f_re, f_im, tr = su3_force.force_and_traces(re, im, beta, lat, nb)
        return F3(f_re, f_im), tr
    return force_and_traces_plain(x, beta, lat, nb, roll)


def force_and_traces_plain(x: F3, beta, lat, nb: int, roll=None):
    """(force, plaq_re_sum per chain) for the Wilson action, sharing the
    plaquette products between the staple force and the action trace.

    VALID FOR UNITARY LINKS ONLY (the physical domain: the down-staple
    identity cancels U_v†U_v); `staples` remains the generic formula.
      U_u(n) A_up_u(n)   = P_uv(n)
      U_u(n) A_down_u(n) = [roll_{+v}(U_v† P_uv U_v)]†
    Training gradients are unaffected by the off-manifold difference:
    every map in the trajectory is group-preserving, so parameter
    perturbations only probe tangential directions, where the two
    formulations' derivatives coincide. Per-link U*A needs 7
    colour-matmuls per plane instead of 8 staple products + 4 applies,
    and tr P comes free."""
    if roll is None:
        roll = make_roll(lat, nb)
    n_dir = _n_dir(lat, nb)
    ua = [None] * 4
    tr_tot = None

    def acc(u, f):
        ua[u] = f if ua[u] is None else add(ua[u], f)

    for u in range(1, 4):
        for v in range(0, u):
            xu = dir_slice(x, u, n_dir)
            xv = dir_slice(x, v, n_dir)
            yuv = mm(xu, roll_f(xv, -1, u, roll))
            yvu = mm(xv, roll_f(xu, -1, v, roll))
            p = mm(yuv, yvu, adj_b=True)
            tr = p.re[0, 0] + p.re[1, 1] + p.re[2, 2]
            tr_tot = tr if tr_tot is None else tr_tot + tr
            q = mm(mm(xv, p, adj_a=True), xv)              # U_v† P U_v
            r = mm(mm(xu, p, adj_a=True, adj_b=True), xu)  # U_u† P† U_u
            acc(u, add(p, adjoint(roll_f(q, 1, v, roll))))
            acc(v, add(adjoint(p), adjoint(roll_f(r, 1, u, roll))))
    force = scale(projectTAH(stack_dirs(ua)), beta / 3.0)
    return force, _chain_sum(tr_tot, nb)


def grad_action(x: F3, beta, lat, nb: int, roll=None,
                c1: float = 0.0) -> F3:
    """Force for UNITARY x (links on the group, see force_and_traces).
    c1 = 0: the closed-form shared-plaquette staple derivative. c1 != 0:
    autograd through the component action, (dS/dre, dS/dim) assembled
    into an F3 and contracted as projectTAH(dS/dU . U†) (the reference's
    autograd route, lattice.py:299-308). Inside a trajectory that is
    itself differentiated the inner graph is kept (create_graph)."""
    if c1 != 0.0:
        outer = torch.is_grad_enabled() and (x.re.requires_grad
                                             or x.im.requires_grad)
        with torch.enable_grad():
            xg = F3(*(t if outer and t.requires_grad
                      else t.detach().requires_grad_() for t in x))
            s = torch.sum(action(xg, beta, lat, nb, roll, c1=c1))
            g = F3(*torch.autograd.grad(s, (xg.re, xg.im),
                                        create_graph=outer))
        return projectTAH(mm(g, x, adj_b=True))
    return force_and_traces(x, beta, lat, nb, roll)[0]


def update_gauge(x: F3, p: F3, s: int = 2) -> F3:
    return mm(expm(p, s=s), x)


def leapfrog(x: F3, v: F3, beta, eps, force: F3, lat, nb: int, roll=None,
             c1: float = 0.0):
    v1 = add(v, scale(force, -0.5 * eps))
    xp = update_gauge(x, scale(v1, eps))
    f2 = grad_action(xp, beta, lat, nb, roll, c1=c1)
    v2 = add(v1, scale(f2, -0.5 * eps))
    return xp, v2, f2


def hmc_trajectory(x: F3, v: F3, beta, eps, nlf: int, lat, nb: int,
                   roll=None, c1: float = 0.0, with_traces: bool = False):
    """nlf leapfrog steps; returns (x', v', dH). For the plain Wilson
    action the plaquette traces ride along with every force evaluation
    (force_and_traces), so the H terms cost no extra matmuls.

    with_traces=True additionally returns (tr0, tr1): the per-chain
    plaquette Re-trace sums of the initial and proposed states, for the
    HMC observers (models/dynamics.py apply_transition_hmc)."""
    if roll is None:
        roll = make_roll(lat, nb)
    if c1 != 0.0:
        f = grad_action(x, beta, lat, nb, roll, c1=c1)
        xp, vp = x, v
        for _ in range(nlf):
            xp, vp, f = leapfrog(xp, vp, beta, eps, f, lat, nb, roll, c1=c1)
        h0 = kinetic_energy(v, nb) + action(x, beta, lat, nb, roll, c1=c1)
        h1 = kinetic_energy(vp, nb) + action(xp, beta, lat, nb, roll, c1=c1)
        if with_traces:
            t0 = _chain_sum(plaq_traces(x, lat, nb, roll)[0], nb)
            t1 = _chain_sum(plaq_traces(xp, lat, nb, roll)[0], nb)
            return xp, vp, h0 - h1, (t0, t1)
        return xp, vp, h0 - h1

    f, tr0 = force_and_traces(x, beta, lat, nb, roll)
    xp, vp, tr1 = x, v, tr0
    for _ in range(nlf):
        v1 = add(vp, scale(f, -0.5 * eps))
        xp = update_gauge(xp, scale(v1, eps))
        f, tr1 = force_and_traces(xp, beta, lat, nb, roll)
        vp = add(v1, scale(f, -0.5 * eps))
    h0 = kinetic_energy(v, nb) + (-beta / 3.0) * tr0
    h1 = kinetic_energy(vp, nb) + (-beta / 3.0) * tr1
    if with_traces:
        return xp, vp, h0 - h1, (tr0, tr1)
    return xp, vp, h0 - h1
