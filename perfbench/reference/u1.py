"""Plain PyTorch reference of 2D U(1) L2HMC: the Wilson action and its
force, the merged generalized-leapfrog trajectory with the NCP x-update
and its log-Jacobian, Metropolis-Hastings, plain HMC, the loss, one
training step (gradient, Adam, batch-norm statistics) and the
observables.

Links are phase angles x of shape (nb, 2*nt*nx), direction-major as
(nb, 2, nt, nx). The update equations are those of L2HMC (Levy, Hoffman,
Sohl-Dickstein 2018) for U(1) as in Foreman et al. 2021 (arXiv:2105.03418),
the NCP update x' = 2 atan(tan(x/2) e^s) + eps (v e^q + t).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import (
    Prec, accept_prob, apply_gradients, bn_ema, loss_term, mh_select, net,
    v_update)

TWO_PI = 2.0 * math.pi


def _lat(x, spec):
    nt, nx = spec["latvolume"]
    return x.reshape(x.shape[0], 2, nt, nx)


def wilson_loops(x, spec):
    """W[t, x] = x_0(t, x) + x_1(t+1, x) - x_0(t, x+1) - x_1(t, x)."""
    xl = _lat(x, spec)
    x0, x1 = xl[:, 0], xl[:, 1]
    return x0 + torch.roll(x1, -1, 1) - torch.roll(x0, -1, 2) - x1


def action(x, beta, spec):
    return beta * torch.sum(1.0 - torch.cos(wilson_loops(x, spec)),
                            dim=(1, 2))


def force(x, beta, spec, prec: Prec):
    """dS/dx: dS/dx_0 = beta (sin W - sin W(x-1)), dS/dx_1 = beta
    (sin W(t-1) - sin W)."""
    sw = torch.sin(wilson_loops(x, spec))
    f0 = sw - torch.roll(sw, 1, 2)
    f1 = torch.roll(sw, 1, 1) - sw
    return prec.store(beta * torch.stack([f0, f1], 1).reshape(x.shape))


def kinetic(v):
    return 0.5 * torch.sum(v * v, dim=1)


def wrap(x):
    """Angles into [-pi, pi)."""
    return torch.remainder(x + math.pi, TWO_PI) - math.pi


def plaqs(x, spec):
    return torch.mean(torch.cos(wilson_loops(x, spec)), dim=(1, 2))


def sin_charge(x, spec):
    return torch.sum(torch.sin(wilson_loops(x, spec)), dim=(1, 2)) / TWO_PI


def _x_update(p, pre, x, v, m, eps, direction, spec, prec, training, dmask):
    mb = 1.0 - m
    xm = m * x
    s, t, q, stats = net(p, pre, torch.cat([torch.cos(xm), torch.sin(xm)], 1),
                         v, spec, prec, training, dmask)
    s, q = eps * s, eps * q
    b = eps * (v * torch.exp(q) + t)
    if direction > 0:
        es = torch.exp(s)
        half = 0.5 * x
        xp = 2.0 * torch.atan(torch.tan(half) * es) + b
    else:
        es = torch.exp(-s)
        half = 0.5 * (x - b)
        xp = 2.0 * torch.atan(torch.tan(half) * es)
    logdet = torch.log(es / (torch.cos(half) ** 2
                             + (es * torch.sin(half)) ** 2))
    return (prec.store(wrap(xm + mb * xp)), torch.sum(mb * logdet, dim=1),
            stats)


def _leapfrog(p, x, v, f, beta, k, direction, spec, prec, training, dmasks):
    """Step k in one direction: v half-update, the two masked x updates
    (the (1 - m) side first going backward), force, v half-update.
    Returns (x, v, force, logdet, {network prefix: [batch stats]})."""
    eps_x = torch.sigmoid(p["xeps"][k])
    eps_v = torch.sigmoid(p["veps"][k])
    m = p["masks"][k]
    vnet, xnet0, xnet1 = (f"vnets.{k}.", f"xnets_first.{k}.",
                          f"xnets_second.{k}.")

    def dm(j):
        if dmasks is None:
            return None
        return dmasks[k * 8 + j + (4 if direction < 0 else 0)]

    stats = {}

    def keep(pre, st):
        if st is not None:
            stats.setdefault(pre, []).append(st)

    s, t, q, st = net(p, vnet, x, f, spec, prec, training, dm(0))
    keep(vnet, st)
    v1, ld = v_update(s, t, q, v, f, eps_v, direction)
    v1 = prec.store(v1)
    sides = ((xnet0, m), (xnet1, 1.0 - m))
    if direction < 0:
        sides = sides[::-1]
    x1 = x
    for j, (pre, mask) in enumerate(sides):
        x1, ldx, st = _x_update(p, pre, x1, v1, mask, eps_x, direction,
                                spec, prec, training, dm(1 + j))
        keep(pre, st)
        ld = ld + ldx
    f2 = force(x1, beta, spec, prec)
    s, t, q, st = net(p, vnet, x1, f2, spec, prec, training, dm(3))
    keep(vnet, st)
    v2, ld2 = v_update(s, t, q, v1, f2, eps_v, direction)
    return x1, prec.store(v2), f2, ld + ld2, stats


def transition(p, x, v, u, beta, spec, prec: Prec, training: bool,
               dmasks=None, bufs=None):
    """One merged L2HMC transition: nlf forward steps, the momentum
    flipped, nlf backward steps in reverse order; then MH."""
    nlf = spec["nleapfrog"]
    remat = training and torch.is_grad_enabled()
    xs, vs = x, v
    sld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    samples: dict = {}
    for direction, order in ((1, range(nlf)), (-1, range(nlf - 1, -1, -1))):
        if direction < 0:
            vs = -vs
        f = force(xs, beta, spec, prec)
        for k in order:
            def step(xs, vs, f, k=k, direction=direction):
                # the network parameters reach the step through `p`
                out = _leapfrog(p, xs, vs, f, beta, k, direction, spec,
                                prec, training, dmasks)
                step.stats = out[4]
                return out[:4]
            if remat:
                xs, vs, f, ld = checkpoint(step, xs, vs, f,
                                           use_reentrant=False)
            else:
                xs, vs, f, ld = step(xs, vs, f)
            sld = sld + ld
            for pre, st in step.stats.items():
                samples.setdefault(pre, []).extend(st)
    dh = (kinetic(v) + action(x, beta, spec)
          - kinetic(vs) - action(xs, beta, spec) + sld)
    acc = accept_prob(dh)
    mask, x_out = mh_select(acc, u, xs, x)
    return {"x_out": x_out, "x_prop": xs, "acc": acc, "mask": mask,
            "sumlogdet": sld, "bn": samples}


def hmc(x, v, u, beta, eps, nlf: int, spec, prec: Prec):
    """Plain HMC: nlf leapfrog steps of size eps (x <- x + eps v), MH."""
    f = force(x, beta, spec, prec)
    xs, vs = x, v
    for _ in range(nlf):
        v1 = prec.store(vs - 0.5 * eps * f)
        xs = prec.store(xs + eps * v1)
        f = force(xs, beta, spec, prec)
        vs = prec.store(v1 - 0.5 * eps * f)
    dh = (kinetic(v) + action(x, beta, spec)
          - kinetic(vs) - action(xs, beta, spec))
    acc = accept_prob(dh)
    mask, x_out = mh_select(acc, u, xs, x)
    return {"x_out": x_out, "x_prop": xs, "acc": acc, "mask": mask}


def loss(x0, xp, acc, spec):
    lw = spec["loss"]
    total = torch.zeros((), dtype=acc.dtype, device=acc.device)
    w1, w2 = wilson_loops(x0, spec), wilson_loops(xp, spec)
    if lw["plaq_weight"] > 0:
        d = torch.sum(torch.cos(w2), (1, 2)) - torch.sum(torch.cos(w1), (1, 2))
        total = total + loss_term(acc * d ** 2, lw["plaq_weight"],
                                  lw["mixed"])
    if lw["charge_weight"] > 0:
        d = (torch.sum(torch.sin(w2), (1, 2))
             - torch.sum(torch.sin(w1), (1, 2))) / TWO_PI
        total = total + loss_term(acc * d ** 2, lw["charge_weight"],
                                  lw["mixed"])
    if lw["rmse_weight"] > 0:
        d = torch.mean((xp - x0) ** 2, dim=1)
        total = total + loss_term(acc * d, lw["rmse_weight"], lw["mixed"])
    return total


def train_step(params: dict, bufs: dict, adam: dict, x, draws: dict, beta,
               spec, prec: Prec) -> dict:
    """One training step on `params` (leaves that require grad), `bufs`
    (running BN statistics, masks) and `adam` (its state), all updated in
    place. Returns the loss, the transition and the gradients as Adam got
    them."""
    names = [k for k, t in params.items() if t.requires_grad]
    p = dict(params, masks=bufs["masks"])
    res = transition(p, x, draws["v"], draws["u"], beta, spec, prec,
                     training=True, dmasks=draws.get("dropout_masks"))
    lval = loss(x, res["x_prop"], res["acc"], spec)
    grads = dict(zip(names, torch.autograd.grad(
        lval, [params[k] for k in names], allow_unused=True)))
    grads = {k: (g if g is not None else torch.zeros_like(params[k]))
             for k, g in grads.items()}
    with torch.no_grad():
        new = {k: params[k].detach() for k in names}
        grads = apply_gradients(new, grads, adam, spec)
        bn_ema(bufs, {pre: pairs for pre, pairs in res["bn"].items()
                      if pre + "bn.r_mean" in bufs})
    for k in names:
        params[k] = new[k].requires_grad_()
    return {"loss": lval.detach(), "x_out": res["x_out"].detach(),
            "acc": res["acc"].detach(), "mask": res["mask"],
            "sumlogdet": res["sumlogdet"].detach(),
            "x_prop": res["x_prop"].detach(), "grads": grads}
