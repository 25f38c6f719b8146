"""Plain PyTorch reference of 4D SU(3) L2HMC on complex 3x3 link
matrices: the Wilson action and its staple force, the merged
generalized-leapfrog trajectory (network momentum updates, the link
update x' = P(exp(+-eps v) x) with P the projection onto SU(3)),
Metropolis-Hastings, plain HMC, the loss, one training step, the
observables, the Wilson flow (Luscher's RK3, arXiv:1006.4518 App. C) and
the clover topological charge.

Links are (nb, 4, nt, nx, ny, nz, 3, 3) complex; direction mu rolls along
axis 1 + mu of a per-direction field (nb, nt, nx, ny, nz, 3, 3). The
matrix exponential is torch.linalg.matrix_exp; the projection is the
polar factor x (x^dag x)^(-1/2) by its binomial series, then the det
phase removed.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import (
    Prec, accept_prob, apply_gradients, loss_term, mh_select, net, v_update)

PLANES = [(u, v) for u in range(1, 4) for v in range(u)]
SQRT1BY3 = math.sqrt(1.0 / 3.0)


def dag(a):
    return a.conj().transpose(-2, -1)


def tr(a):
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


def _eye(a):
    return torch.eye(3, dtype=a.dtype, device=a.device)


def tah(a):
    """Traceless anti-hermitian part."""
    r = 0.5 * (a - dag(a))
    return r - (tr(r) / 3.0)[..., None, None] * _eye(a)


def shift(a, mu: int, n: int = 1):
    """a(x + n mu) of a per-direction field."""
    return torch.roll(a, -n, dims=1 + mu)


def plaquettes(x):
    """[(u, v, P_uv)] with P_uv(n) = U_u(n) U_v(n+u) U_u(n+v)^ U_v(n)^."""
    return [(u, v, x[:, u] @ shift(x[:, v], u) @ dag(shift(x[:, u], v))
             @ dag(x[:, v])) for u, v in PLANES]


def trace_sum(x):
    """Sum of Re tr P over planes and sites, per chain."""
    return sum(tr(p).real.sum(dim=(1, 2, 3, 4)) for _, _, p in
               plaquettes(x))


def action(x, beta):
    return (-beta / 3.0) * trace_sum(x)


def force(x, beta, prec: Prec):
    """(beta / 3) TAH(U_u(n) A_u(n)), A the six-staple sum."""
    out = []
    for u in range(4):
        a = 0
        for v in range(4):
            if v == u:
                continue
            xu, xv = x[:, u], x[:, v]
            up = shift(xv, u) @ dag(shift(xu, v)) @ dag(xv)
            xv_mv = shift(xv, v, -1)
            down = dag(shift(xv_mv, u)) @ dag(shift(xu, v, -1)) @ xv_mv
            a = a + up + down
        out.append(x[:, u] @ a)
    return prec.store((beta / 3.0) * tah(torch.stack(out, 1)))


def kinetic(v):
    n = (v.real ** 2 + v.imag ** 2).sum(dim=(-2, -1)) - 8.0
    return 0.5 * n.reshape(n.shape[0], -1).sum(1)


def project(a, prec: Prec):
    """The SU(3) matrix nearest a near-unitary a: a (a^dag a)^(-1/2), by
    the binomial series of (1 + E)^(-1/2), E = a^dag a - 1, then times
    det^(-1/3) on the principal branch."""
    e = dag(a) @ a - _eye(a)
    r = _eye(a)
    term = _eye(a)
    for c in (-1 / 2, -3 / 4, -5 / 6, -7 / 8, -9 / 10, -11 / 12):
        term = c * (term @ e)
        r = r + term
    w = a @ r
    d = torch.linalg.det(w)
    phase = torch.polar(torch.ones_like(d.real),
                        -torch.atan2(d.imag, d.real) / 3.0)
    return prec.store(w * phase[..., None, None])


def to_vec(a):
    """Eight Gell-Mann coordinates of each link, read off the entries as
    for a traceless anti-hermitian matrix (X^a = -2 tr[T^a X])."""
    return torch.stack([
        -2.0 * a[..., 0, 1].imag, -2.0 * a[..., 0, 1].real,
        a[..., 1, 1].imag - a[..., 0, 0].imag,
        -2.0 * a[..., 0, 2].imag, -2.0 * a[..., 0, 2].real,
        -2.0 * a[..., 1, 2].imag, -2.0 * a[..., 1, 2].real,
        SQRT1BY3 * (2.0 * a[..., 2, 2].imag - a[..., 1, 1].imag
                    - a[..., 0, 0].imag)], dim=-1)


def features(a):
    """(nb, 8 * 4 * V): coordinate-major, then direction and site."""
    c = to_vec(a)
    nb = c.shape[0]
    return c.permute(0, 6, 1, 2, 3, 4, 5).reshape(nb, -1)


def _v_update(p, pre, x, v, f, eps, direction, spec, prec, training):
    s, t, q, _ = net(p, pre, features(x), features(f), spec, prec, training)
    shape = x.shape
    vf, ld = v_update(s.reshape(shape), t.reshape(shape),
                      q.reshape(shape), v, f, eps, direction)
    return prec.store(vf), ld


def _leapfrog(p, x, v, f, beta, k, direction, spec, prec, training):
    """Step k: v half-update, the links moved by exp(+-eps_x v) and
    projected (both masked halves take the same exponential, so every link
    moves once), force, v half-update."""
    eps_x = torch.sigmoid(p["xeps"][k])
    eps_v = torch.sigmoid(p["veps"][k])
    pre = f"vnets.{k}."
    v1, ld = _v_update(p, pre, x, v, f, eps_v, direction, spec, prec,
                       training)
    drift = torch.linalg.matrix_exp((eps_x * direction) * v1)
    x2 = project(drift @ x, prec)
    f2 = force(x2, beta, prec)
    v2, ld2 = _v_update(p, pre, x2, v1, f2, eps_v, direction, spec, prec,
                        training)
    return x2, v2, f2, ld + ld2


def transition(p, x, v, u, beta, spec, prec: Prec, training: bool):
    nlf = spec["nleapfrog"]
    remat = training and torch.is_grad_enabled()
    xs, vs = x, v
    f = force(x, beta, prec)
    sld = torch.zeros(x.shape[0], dtype=x.real.dtype, device=x.device)
    sched = [(k, 1) for k in range(nlf)] + [(k, -1) for k in
                                             reversed(range(nlf))]
    for i, (k, direction) in enumerate(sched):
        if i == nlf:
            vs = -vs

        def step(xs, vs, f, k=k, direction=direction):
            return _leapfrog(p, xs, vs, f, beta, k, direction, spec, prec,
                             training)
        if remat:
            xs, vs, f, ld = checkpoint(step, xs, vs, f, use_reentrant=False)
        else:
            xs, vs, f, ld = step(xs, vs, f)
        sld = sld + ld
    dh = (kinetic(v) + action(x, beta) - kinetic(vs) - action(xs, beta)
          + sld)
    acc = accept_prob(dh)
    mask, x_out = mh_select(acc, u, xs, x)
    return {"x_out": x_out, "x_prop": xs, "acc": acc, "mask": mask,
            "sumlogdet": sld}


def hmc(x, v, u, beta, eps, nlf: int, prec: Prec):
    f = force(x, beta, prec)
    xs, vs = x, v
    for _ in range(nlf):
        v1 = prec.store(vs - 0.5 * eps * f)
        xs = prec.store(torch.linalg.matrix_exp(eps * v1) @ xs)
        f = force(xs, beta, prec)
        vs = prec.store(v1 - 0.5 * eps * f)
    dh = kinetic(v) + action(x, beta) - kinetic(vs) - action(xs, beta)
    acc = accept_prob(dh)
    mask, x_out = mh_select(acc, u, xs, x)
    return {"x_out": x_out, "x_prop": xs, "acc": acc, "mask": mask}


def loss(x0, xp, acc, spec):
    lw = spec["loss"]
    total = torch.zeros((), dtype=acc.dtype, device=acc.device)
    p1 = torch.stack([tr(p) for _, _, p in plaquettes(x0)])
    p2 = torch.stack([tr(p) for _, _, p in plaquettes(xp)])
    vol = math.prod(spec["latvolume"])
    if lw["plaq_weight"] > 0:
        d = p2.real.sum(dim=(2, 3, 4, 5)) - p1.real.sum(dim=(2, 3, 4, 5))
        total = total + loss_term(acc * d ** 2, lw["plaq_weight"],
                                  lw["mixed"])
    if lw["charge_weight"] > 0:
        d = (p2.imag - p1.imag).sum(dim=(0, 2, 3, 4, 5)) / (18 * vol)
        total = total + loss_term(acc * d ** 2, lw["charge_weight"],
                                  lw["mixed"])
    if lw["rmse_weight"] > 0:
        dx = xp - x0
        d = (dx.real ** 2 + dx.imag ** 2).reshape(dx.shape[0], -1).mean(1)
        total = total + loss_term(acc * d, lw["rmse_weight"], lw["mixed"])
    return total


def train_step(params: dict, bufs: dict, adam: dict, x, draws: dict, beta,
               spec, prec: Prec) -> dict:
    names = [k for k, t in params.items() if t.requires_grad]
    res = transition(params, x, draws["v"], draws["u"], beta, spec, prec,
                     training=True)
    lval = loss(x, res["x_prop"], res["acc"], spec)
    grads = dict(zip(names, torch.autograd.grad(
        lval, [params[k] for k in names], allow_unused=True)))
    grads = {k: (g if g is not None else torch.zeros_like(params[k]))
             for k, g in grads.items()}
    with torch.no_grad():
        new = {k: params[k].detach() for k in names}
        grads = apply_gradients(new, grads, adam, spec)
    for k in names:
        params[k] = new[k].requires_grad_()
    return {"loss": lval.detach(), "x_out": res["x_out"].detach(),
            "acc": res["acc"].detach(), "mask": res["mask"],
            "sumlogdet": res["sumlogdet"].detach(),
            "x_prop": res["x_prop"].detach(), "grads": grads}


def observables(x0, x1):
    """Average plaquette, the plaquette charges (sum Im tr P over 32 pi^2
    and over 18 V) of x0, and how far x1 moved them."""
    def charges(x):
        im = sum(tr(p).imag.sum(dim=(1, 2, 3, 4)) for _, _, p in
                 plaquettes(x))
        vol = math.prod(x.shape[2:6])
        return im / (32 * math.pi ** 2), im / (18 * vol)
    vol = math.prod(x0.shape[2:6])
    qi0, qs0 = charges(x0)
    qi1, qs1 = charges(x1)
    return {"plaqs": trace_sum(x0) / (18 * vol), "intQ": qi0, "sinQ": qs0,
            "dQint": (qi1 - qi0).abs(), "dQsin": (qs1 - qs0).abs()}


def flow(x, eps: float, nsteps: int, prec: Prec):
    """Wilson flow dV/dt = Z(V) V, Z = -(2/3) TAH(U A) (the force at beta
    2), by RK3; each step ends with a projection. Returns the flowed links
    and the plaquette trace sums at each step's start."""
    def z(w):
        return -eps * force(w, 2.0, prec)
    trs = []
    for _ in range(nsteps):
        trs.append(trace_sum(x))
        z0 = z(x)
        w1 = prec.store(torch.linalg.matrix_exp(0.25 * z0) @ x)
        z1 = z(w1)
        w2 = prec.store(torch.linalg.matrix_exp(8 / 9 * z1 - 17 / 36 * z0)
                        @ w1)
        z2 = z(w2)
        x = project(torch.linalg.matrix_exp(0.75 * z2 - 8 / 9 * z1
                                            + 17 / 36 * z0) @ w2, prec)
    return x, trs


def clover_charge(x):
    """Q = -(1/64 pi^2) sum Re[tr T10 T32 - tr T20 T31 + tr T30 T21], T_uv
    the traceless anti-hermitian part of the four clover leaves."""
    t = {}
    for u, v in PLANES:
        xu, xv = x[:, u], x[:, v]
        q1 = xu @ shift(xv, u) @ dag(shift(xu, v)) @ dag(xv)
        xu_mu, xv_mu = shift(xu, u, -1), shift(xv, u, -1)
        q2 = xv @ dag(shift(xu_mu, v)) @ dag(xv_mu) @ xu_mu
        q3 = (dag(xu_mu) @ dag(shift(xv_mu, v, -1))
              @ shift(xu_mu, v, -1) @ shift(xv, v, -1))
        xv_mv = shift(xv, v, -1)
        q4 = dag(xv_mv) @ shift(xu, v, -1) @ shift(xv_mv, u) @ dag(xu)
        t[(u, v)] = tah(q1 + q2 + q3 + q4)
    dens = (tr(t[(1, 0)] @ t[(3, 2)]) - tr(t[(2, 0)] @ t[(3, 1)])
            + tr(t[(3, 0)] @ t[(2, 1)])).real
    return -dens.sum(dim=(1, 2, 3, 4)) / (64 * math.pi ** 2)


def flowed_observables(x, eps: float, nsteps: int, prec: Prec) -> dict:
    """What a flowed draw reports: the clover charge after the flow, and
    the plaquette and t^2 E at the start of its last step."""
    xf, trs = flow(x, eps, nsteps, prec)
    vol = math.prod(x.shape[2:6])
    t = (nsteps - 1) * eps
    last = trs[-1]
    return {"flowQ": clover_charge(xf), "flow_plaq": last / (18 * vol),
            "flow_t2E": t * t * (2.0 / vol) * (18 * vol - last) / 3.0}
