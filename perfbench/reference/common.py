"""Plain PyTorch pieces shared by the U(1) and SU(3) references: the
precision a reference runs in, the (s, t, q) networks, the loss terms,
the MH step and optax's Adam.

Nothing here imports the program. The networks read their weights from
a dict keyed by the program's parameter names, which is the one thing the
two sides share: the benchmark draws those weights itself and hands the
same tensors to both.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class Prec:
    """How a reference computes: `dtype` (the real dtype of every field;
    SU(3) fields are its complex counterpart); `tf32`: the networks'
    matrix products take their inputs rounded to TF32's 10-bit mantissa,
    as the card's TF32 GEMMs do; `bf16`: every field is rounded to
    bfloat16 after each update, as a bfloat16 store would hold it. The
    last two are the controls that have to come out not correct."""
    dtype: torch.dtype = torch.float64
    tf32: bool = False
    bf16: bool = False

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 \
            else torch.complex64

    def store(self, t: torch.Tensor) -> torch.Tensor:
        """t as this precision stores it (the identity unless bf16)."""
        if not self.bf16:
            return t
        if t.is_complex():
            return torch.complex(_bf16(t.real), _bf16(t.imag))
        return _bf16(t)


FLOAT64 = Prec()
CONTROLS = {"tf32": Prec(torch.float32, tf32=True),
            "bf16": Prec(torch.float32, bf16=True)}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back, passing the gradient straight through."""
    return t + (t.to(torch.bfloat16).to(t.dtype) - t).detach()


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits, to nearest), the
    gradient passed straight through."""
    bits = t.detach().to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return t + (bits.view(torch.float32).to(t.dtype) - t).detach()


def linear(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           prec: Prec) -> torch.Tensor:
    if prec.tf32:
        z, w = _tf32(z), _tf32(w)
    return F.linear(z, w, b)


ACTIVATIONS = {
    "leaky_relu": lambda z: F.leaky_relu(z, negative_slope=0.01),
    "tanh": torch.tanh,
    "relu": F.relu,
}


def net(p: dict, pre: str, xin: torch.Tensor, vin: torch.Tensor,
        spec: dict, prec: Prec, training: bool,
        dmask: Optional[torch.Tensor] = None, bufs: Optional[dict] = None):
    """One (s, t, q) network: two embeddings summed and activated, the
    hidden stack, dropout (a given keep mask, kept values scaled by
    1/keep), batch norm (biased batch variance in training, the running
    statistics otherwise), and the heads exp(c) tanh(Wz + b), Wz + b,
    exp(c) tanh(Wz + b). Returns (s, t, q, (batch mean, batch var) or
    None)."""
    act = ACTIVATIONS[spec["activation"]]
    z = act(linear(xin, p[pre + "xlayer.weight"], p[pre + "xlayer.bias"],
                   prec)
            + linear(vin, p[pre + "vlayer.weight"], p[pre + "vlayer.bias"],
                     prec))
    i = 0
    while f"{pre}hidden.{i}.weight" in p:
        z = act(linear(z, p[f"{pre}hidden.{i}.weight"],
                       p[f"{pre}hidden.{i}.bias"], prec))
        i += 1
    if training and dmask is not None:
        keep = 1.0 - spec["dropout"]
        z = torch.where(dmask, z / keep, torch.zeros_like(z))
    stats = None
    if pre + "bn.gamma" in p:
        if training:
            mean = z.mean(dim=0, keepdim=True)
            var = torch.square(z - mean).mean(dim=0, keepdim=True)
            stats = (mean[0].detach(), var[0].detach())
        else:
            bufs = p if bufs is None else bufs
            mean = bufs[pre + "bn.r_mean"][None, :]
            var = bufs[pre + "bn.r_var"][None, :]
        z = (z - mean) * torch.rsqrt(var + BN_EPS)
        z = z * p[pre + "bn.gamma"] + p[pre + "bn.beta"]
    s = torch.exp(p[pre + "scale.coeff"]) * torch.tanh(
        linear(z, p[pre + "scale.weight"], p[pre + "scale.bias"], prec))
    t = linear(z, p[pre + "transl.weight"], p[pre + "transl.bias"], prec)
    q = torch.exp(p[pre + "transf.coeff"]) * torch.tanh(
        linear(z, p[pre + "transf.weight"], p[pre + "transf.bias"], prec))
    return prec.store(s), prec.store(t), prec.store(q), stats


def v_update(s, t, q, v, force, eps, direction: int):
    """The generalized momentum update and its log-Jacobian:
        fwd  v' = e^{eps s/2} v - eps/2 (F e^{eps q} + t)
        bwd  v' = e^{-eps s/2} (v + eps/2 (F e^{eps q} + t))
    (t real; for SU(3) it adds to the real part of each matrix entry)."""
    logjac = (0.5 * eps * s) * (1.0 if direction > 0 else -1.0)
    g = force * torch.exp(eps * q) + t
    if direction > 0:
        vf = torch.exp(logjac) * v - 0.5 * eps * g
    else:
        vf = torch.exp(logjac) * (v + 0.5 * eps * g)
    return vf, logjac.reshape(logjac.shape[0], -1).sum(dim=1)


def accept_prob(dh: torch.Tensor) -> torch.Tensor:
    """exp(min(dH, 0)); a non-finite dH is a rejection."""
    dh = torch.where(torch.isfinite(dh), dh, torch.full_like(dh, -math.inf))
    return torch.exp(torch.clamp(dh, max=0.0))


def mh_select(acc, u, prop, init):
    mask = acc > u
    shape = (-1,) + (1,) * (prop.dim() - 1)
    return mask, torch.where(mask.reshape(shape), prop, init)


def loss_term(term: torch.Tensor, weight: float, mixed: bool):
    """One loss term from its per-chain values: non-finite entries count
    0; mixed: w/(a + 1e-4) - (a + 1e-4)/w, else -a/w; the mean."""
    term = torch.where(torch.isfinite(term), term, torch.zeros_like(term))
    if mixed:
        a = term + 1e-4
        return torch.mean(weight / a - a / weight)
    return torch.mean(-term / weight)


def adam_step(params: dict, grads: dict, state: dict, lr: float) -> None:
    """optax.adam in place: m <- m + (1-b1)(g - m), v <- b2 v + (1-b2) g^2,
    p <- p - lr/(1-b1^t) m / (sqrt(v)/sqrt(1-b2^t) + eps)."""
    for name, g in grads.items():
        st = state.setdefault(name, {"t": 0, "m": torch.zeros_like(g),
                                     "v": torch.zeros_like(g)})
        st["t"] += 1
        t = st["t"]
        st["m"] = st["m"] + (1.0 - ADAM_B1) * (g - st["m"])
        st["v"] = ADAM_B2 * st["v"] + (1.0 - ADAM_B2) * g * g
        denom = torch.sqrt(st["v"]) / math.sqrt(1.0 - ADAM_B2 ** t) + ADAM_EPS
        params[name] = (params[name]
                        - lr / (1.0 - ADAM_B1 ** t) * st["m"] / denom)


def apply_gradients(params: dict, grads: dict, state: dict,
                    spec: dict) -> dict:
    """What the trainer does with a loss's gradient: fixed step sizes get
    none, non-finite entries become 0, global-norm clipping, then Adam.
    Returns the gradients as Adam received them."""
    grads = {k: torch.nan_to_num(g) for k, g in grads.items()}
    if spec.get("eps_fixed"):
        for k in ("xeps", "veps"):
            grads[k] = torch.zeros_like(grads[k])
    clip = spec.get("clip_norm", 0.0)
    if clip and clip > 0:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        grads = {k: g * scale for k, g in grads.items()}
    adam_step(params, grads, state, spec["lr"])
    return grads


def bn_ema(bufs: dict, samples: dict) -> None:
    """Fold each network's batch statistics of one step into its running
    ones: r <- (1 - 0.1) r + 0.1 mean(samples). `samples` maps a network
    prefix to its [(mean, var), ...]."""
    for pre, pairs in samples.items():
        m = torch.stack([a for a, _ in pairs]).mean(0)
        v = torch.stack([b for _, b in pairs]).mean(0)
        bufs[pre + "bn.r_mean"] = ((1.0 - BN_MOMENTUM)
                                   * bufs[pre + "bn.r_mean"]
                                   + BN_MOMENTUM * m)
        bufs[pre + "bn.r_var"] = ((1.0 - BN_MOMENTUM) * bufs[pre + "bn.r_var"]
                                  + BN_MOMENTUM * v)
