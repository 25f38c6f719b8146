"""The comparison that decides `correct`: what the timed path produced,
held against the plain reference run in float64 on the same inputs.

Training: the reference follows the first three training steps, which
set-up drives through the window's own call (`Trainer.train`) and feed
before it hands the same trainer to the window: the first runs eagerly
(the program's warm step of its graph), the second and third are graph
replays, as every step of the window is. From their inputs, draws and
beta, each step from the chains and the parameters the program's
previous step left (see `train_numbers`), the reference compares each
step's loss (also at the program's own acceptances, `loss_at_acc`),
the first gradient as Adam received it (read off the program's Adam
state after one step: the eager step's), the change of every parameter and batch-norm
running statistic after three steps, and the chains each step left
(`xout`, also over the first thermalization trajectory before them).
Drawing: the reference redoes a seeded sample of the window's draws from
their inputs and compares the chains, acceptances and observables.

A chain whose reference acceptance lies within the configuration's
`decision_margin` of its uniform may be decided either way by rounding;
its chains are left out of the chain-wise numbers (not of `acc`). The
margin is set from the acceptances' measured rounding (`acc`): in
float32 the program's energies are sums over every link, 1.2 million
terms a chain at SU(3) 8^4 and 512 at U(1) 16x16. `logdet` (the accepted
chains' summed log-Jacobians) is the number nearest the networks: it is
a sum of their outputs and of no energy.
"""
from __future__ import annotations

import math
import statistics

import torch

from perfbench.reference import common, su3, u1
from perfbench.reference.common import FLOAT64, Prec

#: leaves whose first reference gradient is under this share of the
#: median leaf's move under Adam by rounding alone
GRAD_FLOOR = 1e-3


def _ref(spec):
    return u1 if spec["group"] == "U1" else su3


def _to(t, prec: Prec, device=None):
    if t.is_complex():
        return t.to(device=device, dtype=prec.cdtype)
    if t.dtype == torch.bool:
        return t.to(device=device)
    return t.to(device=device, dtype=prec.dtype)


def _draws(d: dict, prec: Prec, device=None) -> dict:
    return {k: _to(v, prec, device) for k, v in d.items()}


def _chain_gap(spec, a, b, keep) -> float:
    """Largest entry gap between two sets of chains, over the chains in
    `keep`; U(1) phases are compared modulo 2 pi."""
    d = a.to(device=b.device, dtype=b.dtype) - b
    if spec["group"] == "U1":
        d = u1.wrap(d)
    d = d.abs().reshape(d.shape[0], -1)[keep]
    return float(d.max()) if d.numel() else 0.0


def _unambiguous(acc, u, spec):
    return (acc - u.to(acc.dtype)).abs() > spec["decision_margin"]


def _leaf_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf |norm(prog) - norm(ref)| / max(norm(ref), the median
    leaf's reference norm)."""
    pn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
          prog.items()}
    rn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
          ref.items()}
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300) for k in rn}


def _by_leaf(out: dict, name: str, gaps: dict) -> None:
    """The worst leaf's gap under `name`, the median leaf's under
    `name`_med, and which leaf was worst."""
    worst = max(gaps, key=gaps.get)
    out[name] = gaps[worst]
    out[name + "_med"] = statistics.median(gaps.values())
    out.setdefault("_worst", {})[name] = worst


def _logdet_gap(prog, r, keep) -> float:
    """Largest gap of the accepted chains' summed log-Jacobians (the
    program reports mask * sumlogdet) over the chains in `keep`."""
    ref = r["mask"].to(r["sumlogdet"].dtype) * r["sumlogdet"]
    gap = (prog.to(device=ref.device, dtype=ref.dtype) - ref)[keep].abs()
    return float(gap.max()) if gap.numel() else 0.0


def initial_state(init, prec: Prec):
    params = {k: _to(v, prec).clone().requires_grad_() for k, v in
              init[0].items()}
    bufs = {k: _to(v, prec).clone() for k, v in init[1].items()}
    return params, bufs


def train_numbers(rec: dict, init, spec: dict,
                  prec: Prec = FLOAT64) -> dict:
    """Training's numbers. Each of the three steps starts from the
    program's parameters before it (Adam turns a gradient that rounding
    alone sets into a step of lr on either side, so the parameters of two
    runs part after one update; the comparison follows the program) and
    the reference's own Adam and batch-norm state."""
    ref = _ref(spec)
    dev = next(iter(init[0].values())).device
    start, bufs = initial_state(init, prec)
    start = {k: v.detach() for k, v in start.items()}
    first_bufs = {k: v.clone() for k, v in bufs.items()}
    adam: dict = {}
    out = {"loss": 0.0, "grad1": 0.0, "dstate3": 0.0, "xout": 0.0,
           "logdet": 0.0, "acc": 0.0}
    th = rec.get("therm")
    if th is not None:
        d = _draws(th["draws"], prec)
        with torch.no_grad():
            args = (_to(th["x_in"], prec), d["v"], d["u"], th["beta"],
                    th["eps"], 2 * spec["nleapfrog"])
            r = (u1.hmc(*args, spec, prec) if spec["group"] == "U1"
                 else su3.hmc(*args, prec))
        out["xout"] = _chain_gap(spec, th["x_out"], r["x_out"],
                                 _unambiguous(r["acc"], d["u"], spec))
    before = start
    for i, s in enumerate(rec["steps"]):
        params = {k: _to(v, prec, dev).clone().requires_grad_()
                  for k, v in before.items()}
        d = _draws(s["draws"], prec, dev)
        r = ref.train_step(params, bufs, adam, _to(s["x_in"], prec, dev), d,
                           s["beta"], spec, prec)
        lr = float(r["loss"])
        gap = abs(float(s["loss"]) - lr) / max(abs(lr), 1e-30)
        out["loss"] = max(out["loss"], gap)
        if i == 0:
            out["loss1"] = gap
        # the loss of the step's proposals at the program's own
        # acceptances: the loss's reduction over the chains, free of the
        # acceptances' float32 rounding
        with torch.no_grad():
            at = float(ref.loss(_to(s["x_in"], prec, dev), r["x_prop"],
                                _to(s["acc"], prec, dev), spec))
        out["loss_at_acc"] = max(out.get("loss_at_acc", 0.0), abs(
            float(s["loss"]) - at) / max(abs(at), 1e-30))
        keep = _unambiguous(r["acc"], d["u"], spec)
        out["acc"] = max(out["acc"], float((s["acc"].double().cpu()
                                            - r["acc"].double().cpu())
                                           .abs().max()))
        out["xout"] = max(out["xout"], _chain_gap(spec, s["x_out"],
                                                  r["x_out"], keep))
        out["logdet"] = max(out["logdet"], _logdet_gap(
            s["sumlogdet"], r, keep))
        if i == 0:
            g1 = {k: v.detach().clone() for k, v in r["grads"].items()}
        before = s["params_out"]
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in g1.items()}
    med = statistics.median(norms.values())
    counted = [k for k, n in norms.items() if n >= GRAD_FLOOR * med]
    b1 = 1.0 - common.ADAM_B1
    _by_leaf(out, "grad1", _leaf_gaps(
        {k: rec["exp_avg1"][k] / b1 for k in counted},
        {k: g1[k] for k in counted}))
    prog = {k: before[k] for k in counted}
    prog.update(rec["buffers_out"])
    now = {k: params[k].detach() for k in counted}
    now.update({k: bufs[k] for k in rec["buffers_out"]})
    first = dict(start, **first_bufs)
    _by_leaf(out, "dstate3", _leaf_gaps(
        {k: prog[k].double().cpu() - first[k].double().cpu() for k in prog},
        {k: now[k].double().cpu() - first[k].double().cpu() for k in prog}))
    return out


def draw_numbers(rec: dict, init, spec: dict, job: str,
                 prec: Prec = FLOAT64) -> dict:
    params, bufs = initial_state(init, prec)
    p = {**{k: v.detach() for k, v in params.items()}, **bufs}
    out: dict = {}

    def worst(name, value):
        out[name] = max(out.get(name, 0.0), value)

    for s in rec["samples"].values():
        d = _draws(s["draws"], prec)
        x = _to(s["x_in"], prec)
        m = s["metrics"]
        with torch.no_grad():
            if job == "hmc":
                nlf = 2 * spec["nleapfrog"]
                r = (u1.hmc(x, d["v"], d["u"], s["beta"], s["eps"], nlf,
                            spec, prec) if spec["group"] == "U1"
                     else su3.hmc(x, d["v"], d["u"], s["beta"], s["eps"],
                                  nlf, prec))
            else:
                r = _ref(spec).transition(p, x, d["v"], d["u"], s["beta"],
                                          spec, prec, training=False)
        keep = _unambiguous(r["acc"], d["u"], spec)
        worst("xout", _chain_gap(spec, s["x_out"], r["x_out"], keep))
        worst("acc", float((m["acc"].double() - r["acc"].double())
                           .abs().max()))
        if spec["group"] == "U1":
            ref_plaq = u1.plaqs(x, spec)
            dq = (u1.sin_charge(r["x_out"], spec)
                  - u1.sin_charge(x, spec)).abs()
            worst("plaq", float((m["plaqs"].double() - ref_plaq)
                                .abs().max()))
            worst("dqsin", float((m["dQsin"].double() - dq)[keep].abs()
                                 .max()) if keep.any() else 0.0)
            continue
        obs = su3.observables(x, r["x_out"])
        worst("plaq", float((m["plaqs"].double() - obs["plaqs"])
                            .abs().max()))
        if "sumlogdet" in r:
            worst("logdet", _logdet_gap(m["sumlogdet"], r, keep))
        if "flow" in s:
            with torch.no_grad():
                f = su3.flowed_observables(r["x_out"], spec["flow_eps"],
                                           spec["flow_nsteps"], prec)
            for key, name in (("flowQ", "flowq"), ("flow_plaq", "flowplaq")):
                gap = (s["flow"][key].double() - f[key])[keep].abs()
                worst(name, float(gap.max()) if gap.numel() else 0.0)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, number, limit)]) over the numbers the cell's
    limits name: every one given and at or under its limit. The others
    a comparison gives are reported beside, not judged."""
    rows = [(k, numbers.get(k, math.nan), lim)
            for k, lim in sorted(limits.items())]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim
                            for _, v, lim in rows)
    return ok, rows
