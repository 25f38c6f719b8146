"""Shared helpers for the parity tests between the JAX package (the
reference) and its PyTorch port.

Data crosses between the two as numpy arrays. JAX's threefry and torch's
Philox never draw the same numbers, so the random draws a JAX function
makes are replayed here from its key splits and handed to the port as
tensors.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from l2hmc_torch.models.dynamics import Dynamics as TorchDynamics


def to_np(a) -> np.ndarray:
    return np.array(a)


def to_torch(a) -> torch.Tensor:
    """jax/numpy array -> torch tensor of the same dtype (a copy)."""
    return torch.from_numpy(np.array(a))


def params_to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def dropout_masks(k_drop, nlf: int, nb: int, units: int, keep: float):
    """All dropout masks of one JAX trajectory: row r is the mask drawn
    with fold_in(k_drop, r), r = step*8 + call + (4 if backward)
    (dynamics.py `_lf_step.dkey`, networks.py bernoulli)."""
    rows = [np.asarray(jax.random.bernoulli(jax.random.fold_in(k_drop, r),
                                            keep, (nb, units)))
            for r in range(8 * nlf)]
    return torch.from_numpy(np.stack(rows))


def fb_draws(dyn, x, key, training: bool = False) -> dict:
    """The draws `Dynamics.apply_transition_fb(..., key)` makes:
    k_v, k_acc, k_drop = split(key, 3) (dynamics.py:885)."""
    k_v, k_acc, k_drop = jax.random.split(key, 3)
    nb = x.shape[0]
    v = dyn.random_v(k_v, x)
    u = jax.random.uniform(k_acc, (nb,), dtype=dyn.real_dtype)
    out = {"v": to_torch(v), "u": to_torch(u)}
    ncfg = dyn.network_config
    if training and ncfg.dropout_prob > 0:
        out["dropout_masks"] = dropout_masks(
            k_drop, dyn.nlf, nb, int(ncfg.units[-1]), 1.0 - ncfg.dropout_prob)
    return out


def hmc_draws(dyn, x, key) -> dict:
    """The draws `Dynamics.apply_transition_hmc(..., key)` makes."""
    k_v, k_acc = jax.random.split(key)
    v = dyn.random_v(k_v, x)
    u = jax.random.uniform(k_acc, (x.shape[0],), dtype=dyn.real_dtype)
    return {"v": to_torch(v), "u": to_torch(u)}


def port_dynamics(dyn, params, masks, dtype=torch.float64) -> TorchDynamics:
    """The port's Dynamics with the JAX dynamics' configs, weights and
    masks."""
    tdyn = TorchDynamics(dyn.config, dyn.network_config, dyn.net_weights,
                         dtype=dtype)
    tdyn.load_jax_params(params_to_numpy(params), np.asarray(masks))
    return tdyn


def jax_f64(a):
    return jnp.asarray(np.asarray(a), dtype=jnp.float64)
