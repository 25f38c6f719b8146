"""The control and the faults: the plain reference put in the program's
place, run in a lower precision or broken on purpose, and judged by the
same comparison as a run. Their numbers are the upper readings the
limits are set below; they are read on the card at the cell's own size
(`python3 perfbench/control.py <workload> <seed>...`) and at the
rehearsal size by the tests.

Variants:
  sound    the reference in float32, as the program computes;
  control  the cell's control precision (limits/<cell>.json): TF32
           (on the card its own TF32 in every float32 product; on the
           CPU the networks' products emulated), or fields stored in
           bfloat16;
  nettf32  TF32 emulated in the networks' products alone;
  half     training's loss taken over half of the chains;
  answer   every step's output chains altered where they are produced:
           chain 0 given chain 1's links.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import bench, check, inputs  # noqa: E402
from perfbench.reference import su3, u1  # noqa: E402
from perfbench.reference.common import CONTROLS, Prec  # noqa: E402

FLOAT32 = Prec(torch.float32)
THERMALIZE = 20


def _alter(x):
    x = x.clone()
    x[0] = x[1]
    return x


def _start(cell, seed, device):
    spec = cell.spec
    job = cell.traffic["job"]
    nb = spec["chains"]["train" if job == "train" else "draw"]
    dtype = torch.float32 if spec["group"] == "U1" else torch.complex64
    init = inputs.make_state(*inputs.layout(spec), spec,
                             cell.config.get("weights", {}),
                             inputs.generator(seed, 0, device), device)
    x = inputs.start_links(spec, nb, inputs.generator(seed, 1, device),
                           device, dtype)
    gen = inputs.generator(seed, 2, device)
    # chains brought towards equilibrium by the reference's HMC, as the
    # program's thermalization brings them before its first step
    with torch.no_grad():
        for _ in range(int(cell.traffic.get("thermalize", THERMALIZE))):
            d = inputs.step_draws(x, spec, gen)
            args = (x, d["v"], d["u"], spec["beta"], spec["eps_hmc"],
                    2 * spec["nleapfrog"])
            r = (u1.hmc(*args, spec, FLOAT32) if spec["group"] == "U1"
                 else su3.hmc(*args, FLOAT32))
            x = r["x_out"]
    return init, x, gen


def program_record(cell, seed: int, variant: str, device) -> tuple:
    """(record, init) as a run of the cell would keep them, with the
    reference in the program's place."""
    spec = cell.spec
    ref = u1 if spec["group"] == "U1" else su3
    prec = {"control": CONTROLS[cell.control],
            "nettf32": CONTROLS["tf32"]}.get(variant, FLOAT32)
    if variant == "control" and prec.tf32 and str(device).startswith("cuda"):
        prec = FLOAT32     # the card's own TF32, set by `numbers`
    init, x, gen = _start(cell, seed, device)
    beta = spec["beta"]
    if cell.traffic["job"] == "train":
        rows = 8 * spec["nleapfrog"] if spec.get("dropout", 0) > 0 else 0
        params, bufs = check.initial_state(init, prec)
        adam: dict = {}
        rec = {"steps": [], "therm": None}
        loss = ref.loss
        if variant == "half":
            def half(x0, xp, acc, spec):
                n = x0.shape[0] // 2
                return loss(x0[:n], xp[:n], acc[:n], spec)
            ref.loss = half
        try:
            for i in range(3):
                d = inputs.step_draws(x, spec, gen, rows)
                r = ref.train_step(params, bufs, adam,
                                   prec.store(check._to(x, prec)),
                                   check._draws(d, prec), beta, spec, prec)
                xo = r["x_out"].to(x.dtype)
                if variant == "answer":
                    xo = _alter(xo)
                rec["steps"].append({
                    "x_in": x, "beta": beta, "draws": d, "x_out": xo,
                    "loss": r["loss"], "acc": r["acc"],
                    "sumlogdet": r["mask"].to(r["acc"].dtype)
                    * r["sumlogdet"],
                    "params_out": {k: v.detach().clone()
                                   for k, v in params.items()}})
                if i == 0:
                    rec["exp_avg1"] = {k: s["m"].clone()
                                       for k, s in adam.items()}
                x = xo
        finally:
            ref.loss = loss
        rec["buffers_out"] = {k: v for k, v in bufs.items()
                              if k.endswith(("r_mean", "r_var"))}
        return rec, init
    params, bufs = check.initial_state(init, prec)
    p = {**{k: v.detach() for k, v in params.items()}, **bufs}
    rec = {"samples": {}}
    for i in range(int(cell.traffic["check_steps"])):
        d = inputs.step_draws(x, spec, gen)
        xp, dp = prec.store(check._to(x, prec)), check._draws(d, prec)
        s = {"x_in": x, "beta": beta, "draws": d}
        with torch.no_grad():
            if cell.traffic["job"] == "hmc":
                s["eps"] = spec["eps_hmc"]
                nlf = 2 * spec["nleapfrog"]
                r = (u1.hmc(xp, dp["v"], dp["u"], beta, s["eps"], nlf, spec,
                            prec) if spec["group"] == "U1"
                     else su3.hmc(xp, dp["v"], dp["u"], beta, s["eps"], nlf,
                                  prec))
            else:
                r = ref.transition(p, xp, dp["v"], dp["u"], beta, spec, prec,
                                   training=False)
            out = r["x_out"]
            if spec["group"] == "U1":
                m = {"plaqs": u1.plaqs(xp, spec),
                     "dQsin": (u1.sin_charge(out, spec)
                               - u1.sin_charge(xp, spec)).abs()}
            else:
                m = {"plaqs": su3.observables(xp, out)["plaqs"]}
                if "sumlogdet" in r:
                    m["sumlogdet"] = r["mask"].to(r["acc"].dtype) \
                        * r["sumlogdet"]
                if spec.get("flow_nsteps", 0) > 0:
                    s["flow"] = su3.flowed_observables(
                        out, spec["flow_eps"], spec["flow_nsteps"], prec)
        m["acc"] = r["acc"]
        xo = out.to(x.dtype)
        if variant == "answer":
            xo = _alter(xo)
        s.update(x_out=xo, metrics=m)
        rec["samples"][i] = s
        x = xo
    return rec, init


def numbers(cell, seed: int, variant: str, device) -> dict:
    tf32 = variant == "control" and cell.control == "tf32" and str(
        device).startswith("cuda")
    # on the card the TF32 control is the card's own TF32 (every float32
    # product, forward and backward); on the CPU it is emulated
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        rec, init = program_record(cell, seed, variant, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    if cell.traffic["job"] == "train":
        out = check.train_numbers(rec, init, cell.spec)
        out.pop("_worst")
        return out
    return check.draw_numbers(rec, init, cell.spec, cell.traffic["job"])


def main(argv) -> int:
    """workload seed... [--variants a,b] [--rehearsal]: one JSON line of
    numbers per variant and seed."""
    variants = ["sound", "control", "nettf32", "half", "answer"]
    rehearsal = "--rehearsal" in argv
    args = [a for a in argv if not a.startswith("--")]
    for a in argv:
        if a.startswith("--variants="):
            variants = a.split("=", 1)[1].split(",")
    cell = bench.load_cell(args[0], rehearsal=rehearsal)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if cell.traffic["job"] != "train":
        variants = [v for v in variants if v not in ("half", "nettf32")]
    for seed in args[1:]:
        for v in variants:
            print(json.dumps({"workload": cell.name, "seed": int(seed),
                              "variant": v, "numbers": numbers(
                                  cell, int(seed), v, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
