"""LeapfrogLayer (s, t, q) networks as `nn.Module`s.

PyTorch counterpart of the JAX package's `models/networks.py` (after the
reference's src/l2hmc/network/pytorch/network.py): `InputLayer` (:349-451)
= two linear embeddings summed then activated, a hidden MLP stack
(:492-495), heads `scale`/`transf` = ScaledTanh `exp(coeff) * tanh(Wz+b)`
(:175-206) and `transl` = Linear (:499-501), optional dropout (:503) and
batch norm (:507), and NetWeight output scaling (:548-551).

Where this differs from stock torch layers, it follows the JAX package:
- dropout is `where(mask, z / keep, 0)` with an injectable mask;
- batch norm normalizes with the biased batch variance and eps 1e-5 in
  training, with the running statistics at eval; the running statistics
  are buffers that the Trainer folds (EMA, momentum 0.1) from the batch
  statistics the layer returns — not `nn.BatchNorm1d`'s own update;
- `compute_dtype` (bf16) casts parameters and inputs for the GEMM stack
  and casts the outputs back.

The U(1) conv front-end (JAX networks.py:71-129) is not ported yet.

`from_jax_params` builds a layer from the JAX parameter tree (as numpy
arrays). JAX stores a linear weight as (din, dout) and computes z @ w, so
the torch weight is its transpose.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from l2hmc_torch.configs import NetWeight, NetworkConfig

ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "tanh": torch.tanh,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "swish": F.silu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}

BN_EPS = 1e-5


class ScaledTanh(nn.Linear):
    """exp(coeff) * tanh(W z + b)."""

    def __init__(self, din: int, dout: int, dtype=torch.float32):
        super().__init__(din, dout, dtype=dtype)
        self.coeff = nn.Parameter(torch.zeros((1, dout), dtype=dtype))


class BatchNormParams(nn.Module):
    """Affine parameters plus running statistics (buffers) of one BN."""

    def __init__(self, units: int, dtype=torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(units, dtype=dtype))
        self.beta = nn.Parameter(torch.zeros(units, dtype=dtype))
        self.register_buffer("r_mean", torch.zeros(units, dtype=dtype))
        self.register_buffer("r_var", torch.ones(units, dtype=dtype))


def _linear(layer: nn.Linear, z: torch.Tensor, cd=None) -> torch.Tensor:
    w, b = layer.weight, layer.bias
    if cd is not None:
        w, b = w.to(cd), b.to(cd)
    return F.linear(z, w, b)


def _scaled_tanh(layer: ScaledTanh, z: torch.Tensor, cd=None):
    coeff = layer.coeff if cd is None else layer.coeff.to(cd)
    return torch.exp(coeff) * torch.tanh(_linear(layer, z, cd))


class LeapfrogLayer(nn.Module):
    """(x, v) -> (s, t, q), each (nb, out_dim)."""

    def __init__(self, x_dim: int, v_dim: int, out_dim: int,
                 cfg: NetworkConfig, net_weight: NetWeight,
                 dtype=torch.float32, compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.net_weight = net_weight
        self.compute_dtype = compute_dtype
        self.act = ACTIVATIONS[cfg.activation_fn]
        units = [int(u) for u in cfg.units]
        self.xlayer = nn.Linear(x_dim, units[0], dtype=dtype)
        self.vlayer = nn.Linear(v_dim, units[0], dtype=dtype)
        self.hidden = nn.ModuleList(
            nn.Linear(units[i], units[i + 1], dtype=dtype)
            for i in range(len(units) - 1))
        self.scale = ScaledTanh(units[-1], out_dim, dtype=dtype)
        self.transl = nn.Linear(units[-1], out_dim, dtype=dtype)
        self.transf = ScaledTanh(units[-1], out_dim, dtype=dtype)
        self.bn = (BatchNormParams(units[-1], dtype)
                   if cfg.use_batch_norm else None)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch.nn.Linear's default init, U(-1/sqrt(din), 1/sqrt(din)) for
        weight and bias, drawn from `generator`; zero heads when
        cfg.zero_init_heads (the untrained kernel is then plain HMC)."""
        linears = [self.xlayer, self.vlayer, *self.hidden, self.scale,
                   self.transl, self.transf]
        for lin in linears:
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)
        self.scale.coeff.zero_()
        self.transf.coeff.zero_()
        if self.cfg.zero_init_heads:
            for head in (self.scale, self.transl, self.transf):
                for p in head.parameters():
                    p.zero_()

    def forward(self, x: torch.Tensor, v: torch.Tensor,
                training: bool = False,
                dropout_mask: Optional[torch.Tensor] = None,
                collect_bn: bool = False):
        """Returns (s, t, q), plus (batch_mean, batch_var) of the BN input
        (detached; None when no batch statistics ran) when collect_bn.
        Dropout runs only in training and only with a mask given."""
        cd = self.compute_dtype
        out_dtype = x.dtype
        if cd is not None:
            x = x.to(cd)
            v = v.to(cd)
        z = self.act(_linear(self.xlayer, x, cd) + _linear(self.vlayer, v, cd))
        for h in self.hidden:
            z = self.act(_linear(h, z, cd))
        if training and self.cfg.dropout_prob > 0 and dropout_mask is not None:
            keep = 1.0 - self.cfg.dropout_prob
            z = torch.where(dropout_mask, z / keep, torch.zeros_like(z))
        bn_stats = None
        if self.bn is not None:
            bn = self.bn
            if not training and self.cfg.bn_track_running_stats:
                mean, var = bn.r_mean[None, :], bn.r_var[None, :]
                if cd is not None:
                    mean, var = mean.to(cd), var.to(cd)
            else:
                mean = torch.mean(z, dim=0, keepdim=True)
                var = torch.mean(torch.square(z - mean), dim=0, keepdim=True)
                if collect_bn:
                    bn_stats = (mean[0].detach().to(out_dtype),
                                var[0].detach().to(out_dtype))
            gamma, beta = bn.gamma, bn.beta
            if cd is not None:
                gamma, beta = gamma.to(cd), beta.to(cd)
            z = (z - mean) * torch.rsqrt(var + BN_EPS)
            z = z * gamma + beta
        nw = self.net_weight
        s = nw.s * _scaled_tanh(self.scale, z, cd)
        t = nw.t * _linear(self.transl, z, cd)
        q = nw.q * _scaled_tanh(self.transf, z, cd)
        if cd is not None:
            s, t, q = s.to(out_dtype), t.to(out_dtype), q.to(out_dtype)
        if collect_bn:
            return s, t, q, bn_stats
        return s, t, q

    @torch.no_grad()
    def load_jax_params(self, tree: dict) -> None:
        """Copy one (unstacked) JAX LeapfrogLayer tree of numpy arrays into
        this module."""
        if "conv" in tree:
            raise NotImplementedError(
                "the U(1) conv front-end is not ported to l2hmc_torch yet")

        def put(dst: torch.Tensor, a, transpose=False):
            a = np.asarray(a)
            t = torch.from_numpy(np.array(a.T if transpose else a))
            if tuple(t.shape) != tuple(dst.shape):
                raise ValueError(f"shape {tuple(t.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(t.to(dst.dtype))

        def put_linear(lin, p):
            put(lin.weight, p["w"], transpose=True)
            put(lin.bias, p["b"])

        put_linear(self.xlayer, tree["xlayer"])
        put_linear(self.vlayer, tree["vlayer"])
        if len(tree["hidden"]) != len(self.hidden):
            raise ValueError("hidden depth differs from the JAX tree")
        for lin, p in zip(self.hidden, tree["hidden"]):
            put_linear(lin, p)
        for name in ("scale", "transl", "transf"):
            put_linear(getattr(self, name), tree[name])
        put(self.scale.coeff, tree["scale"]["coeff"])
        put(self.transf.coeff, tree["transf"]["coeff"])
        if (self.bn is None) != ("bn" not in tree):
            raise ValueError("batch norm on/off differs from the JAX tree")
        if self.bn is not None:
            for name in ("gamma", "beta", "r_mean", "r_var"):
                put(getattr(self.bn, name), tree["bn"][name])


def from_jax_params(tree: dict, cfg: NetworkConfig,
                    net_weight: Optional[NetWeight] = None,
                    dtype=None, compute_dtype=None) -> LeapfrogLayer:
    """Build a LeapfrogLayer from one (unstacked) JAX parameter tree of
    numpy arrays; the dims come from the tree's shapes."""
    if "conv" in tree:
        raise NotImplementedError(
            "the U(1) conv front-end is not ported to l2hmc_torch yet")
    xw = np.asarray(tree["xlayer"]["w"])
    dtype = dtype or torch.from_numpy(np.zeros(0, xw.dtype)).dtype
    layer = LeapfrogLayer(
        x_dim=xw.shape[0], v_dim=np.asarray(tree["vlayer"]["w"]).shape[0],
        out_dim=np.asarray(tree["scale"]["w"]).shape[1], cfg=cfg,
        net_weight=net_weight or NetWeight(), dtype=dtype,
        compute_dtype=compute_dtype)
    layer.load_jax_params(tree)
    return layer


def index_tree(tree, i: int):
    """Slice step i out of a tree stacked on the leapfrog axis."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [index_tree(v, i) for v in tree]
    return np.asarray(tree)[i]
