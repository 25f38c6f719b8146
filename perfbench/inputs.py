"""Everything a run feeds the program, made from `--seed` on the run's
device: the network weights and masks, the starting links, and every
step's random draws (momenta, MH uniforms, dropout masks).

The same tensors go to the program and to the reference, so neither
side's random numbers depend on the other's code. The weights follow
torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
(s, t, q) head layers scaled by the configuration's `head_scale`; the
step sizes start at log(eps), batch norm at its identity, the running
statistics at (0, 1).
"""
from __future__ import annotations

import math

import torch

HEADS = ("scale.", "transl.", "transf.")
SQRT_HALF = math.sqrt(0.5)
SQRT_SIXTH = math.sqrt(1.0 / 6.0)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one stream of draws (weights, start, steps) of a
    run; `seed` may take any value up to 64 bits."""
    g = torch.Generator(device=device)
    return g.manual_seed((int(seed) * 4 + stream) % (2 ** 63))


def _net_layout(pre: str, x_dim: int, v_dim: int, out: int, spec: dict):
    u = list(spec["units"])
    ps = [(pre + "xlayer.weight", (u[0], x_dim)), (pre + "xlayer.bias", (u[0],)),
          (pre + "vlayer.weight", (u[0], v_dim)), (pre + "vlayer.bias", (u[0],))]
    for i, (a, b) in enumerate(zip(u, u[1:])):
        ps += [(f"{pre}hidden.{i}.weight", (b, a)), (f"{pre}hidden.{i}.bias",
                                                     (b,))]
    for head in ("scale", "transl", "transf"):
        ps += [(f"{pre}{head}.weight", (out, u[-1])),
               (f"{pre}{head}.bias", (out,))]
        if head != "transl":
            ps.append((f"{pre}{head}.coeff", (1, out)))
    bs = []
    if spec["batch_norm"]:
        ps += [(pre + "bn.gamma", (u[-1],)), (pre + "bn.beta", (u[-1],))]
        bs = [(pre + "bn.r_mean", (u[-1],)), (pre + "bn.r_var", (u[-1],))]
    return ps, bs


def layout(spec: dict) -> tuple[list, list]:
    """The dynamics' (parameters, buffers) as [(name, shape)], in the
    program's order: step sizes, then per leapfrog step the momentum
    networks, for U(1) the two position networks, and the masks."""
    nlf = spec["nleapfrog"]
    vol = math.prod(spec["latvolume"])
    ps = [("xeps", (nlf,)), ("veps", (nlf,))]
    bs = []
    if spec["group"] == "U1":
        d = 2 * vol
        nets = [("vnets", d, d), ("xnets_first", 2 * d, d),
                ("xnets_second", 2 * d, d)]
        mask_dim = d
    else:
        links = 4 * vol
        nets = [("vnets", 8 * links, 8 * links)]
        mask_dim = links
    out = d if spec["group"] == "U1" else 9 * links
    for name, x_dim, v_dim in nets:
        for k in range(nlf):
            p, b = _net_layout(f"{name}.{k}.", x_dim, v_dim, out, spec)
            ps += p
            bs += b
    return ps, [("masks", (nlf, mask_dim))] + bs


def make_state(named_params, named_buffers, spec: dict, weights: dict,
               gen: torch.Generator, device) -> tuple[dict, dict]:
    """(parameters, buffers) by the program's names. One draw of uniforms
    for every linear layer's weight and bias, then scaled per leaf."""
    shapes = dict(named_params)
    drawn = [n for n, s in named_params
             if n.endswith((".weight", ".bias"))]
    total = sum(math.prod(shapes[n]) for n in drawn)
    u = torch.rand(total, generator=gen, device=device,
                   dtype=torch.float32).mul_(2.0).sub_(1.0)
    params, off = {}, 0
    for n in drawn:
        k = math.prod(shapes[n])
        fan_in = shapes[n.rsplit(".", 1)[0] + ".weight"][1]
        bound = 1.0 / math.sqrt(fan_in)
        if n.rsplit(".", 2)[-2] + "." in HEADS:
            bound *= float(weights.get("head_scale", 1.0))
        params[n] = u[off:off + k].view(shapes[n]).mul_(bound)
        off += k
    for n, s in named_params:
        if n in ("xeps", "veps"):
            params[n] = torch.full(s, math.log(spec["eps"]), device=device)
        elif n.endswith("coeff") or n.endswith("bn.beta"):
            params[n] = torch.zeros(s, device=device)
        elif n.endswith("bn.gamma"):
            params[n] = torch.ones(s, device=device)
    bufs = {}
    for n, s in named_buffers:
        if n == "masks":
            # each step's mask holds half of the links (or U(1) phases)
            order = torch.rand(s, generator=gen, device=device).argsort(1)
            bufs[n] = (order < s[1] // 2).to(torch.float32)
        elif n.endswith("r_mean"):
            bufs[n] = torch.zeros(s, device=device)
        elif n.endswith("r_var"):
            bufs[n] = torch.ones(s, device=device)
    missing = {n for n, _ in named_params} - set(params)
    missing |= {n for n, _ in named_buffers} - set(bufs)
    if missing:
        raise ValueError(f"no rule draws {sorted(missing)}")
    return params, bufs


def start_links(spec: dict, nb: int, gen: torch.Generator, device,
                dtype: torch.dtype):
    """U(1): uniform phases in [-pi, pi). SU(3): a warm start, each link
    exp(w P) with P a Gaussian algebra element and w the configuration's
    `start_width` (an ordered start at 8^4 rejects every HMC trajectory,
    so its thermalization would not move). In the program's dtype, drawn
    in float32."""
    if spec["group"] == "U1":
        nt, nx = spec["latvolume"]
        u = torch.rand((nb, 2 * nt * nx), generator=gen, device=device)
        return (2.0 * math.pi * u - math.pi).to(dtype)
    p = su3_momenta((nb, 4, *spec["latvolume"]), gen, device)
    return torch.linalg.matrix_exp(spec["start_width"] * p.to(dtype))


def su3_momenta(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Gaussian traceless anti-hermitian 3x3 matrices, exp(-|P|_F^2 / 2)
    over the algebra: eight standard normals per link on an orthonormal
    basis."""
    n = torch.randn((8, *shape), generator=gen, device=device)
    a01, a02, a12 = (SQRT_HALF * n[i] for i in range(3))
    b01, b02, b12 = (SQRT_HALF * n[i] for i in range(3, 6))
    d3, d8 = SQRT_HALF * n[6], SQRT_SIXTH * n[7]
    z = torch.zeros_like(d3)
    re = torch.stack([torch.stack([z, a01, a02], -1),
                      torch.stack([-a01, z, a12], -1),
                      torch.stack([-a02, -a12, z], -1)], -2)
    im = torch.stack([torch.stack([d3 + d8, b01, b02], -1),
                      torch.stack([b01, -d3 + d8, b12], -1),
                      torch.stack([b02, b12, -2.0 * d8], -1)], -2)
    return torch.complex(re, im)


def step_draws(x: torch.Tensor, spec: dict, gen: torch.Generator,
               dropout_rows: int = 0) -> dict:
    """One step's draws for the chains of x: momenta `v`, MH uniforms `u`
    and, when `dropout_rows` > 0, the keep masks of a trajectory's network
    calls, (rows, nb, units[-1]). Drawn in float32, given in x's dtype."""
    nb = x.shape[0]
    if spec["group"] == "U1":
        v = torch.randn(x.shape, generator=gen, device=x.device)
    else:
        v = su3_momenta(x.shape[:-2], gen, x.device)
    real = torch.empty((), dtype=x.dtype).real.dtype
    u = torch.rand((nb,), generator=gen, device=x.device)
    out = {"v": v.to(x.dtype), "u": u.to(real)}
    if dropout_rows:
        keep = 1.0 - spec["dropout"]
        shape = (dropout_rows, nb, spec["units"][-1])
        out["dropout_masks"] = torch.rand(shape, generator=gen,
                                          device=x.device) < keep
    return out
