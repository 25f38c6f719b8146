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
import pytest
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


def torch_dtype(jdtype) -> torch.dtype:
    """The torch dtype of a jax/numpy dtype (complex ones included)."""
    return torch.from_numpy(np.zeros(0, np.dtype(jdtype))).dtype


def port_dynamics(dyn, params, masks, dtype=None) -> TorchDynamics:
    """The port's Dynamics with the JAX dynamics' configs (conv front-end
    and c1 included), dtype (complex for SU(3)), weights and masks."""
    tdyn = TorchDynamics(dyn.config, dyn.network_config, dyn.net_weights,
                         conv=dyn.conv, dtype=dtype or torch_dtype(dyn.dtype),
                         c1=dyn.c1)
    tdyn.load_jax_params(params_to_numpy(params), np.asarray(masks))
    return tdyn


def jax_f64(a):
    return jnp.asarray(np.asarray(a), dtype=jnp.float64)


# ---------------------------------------------------------------------------
# SU(3)
# ---------------------------------------------------------------------------
LAT = (2, 2, 2, 2)


@pytest.fixture
def eager():
    """The JAX package's SU(3) graphs take minutes to compile on the CPU;
    the math is the same op by op, so the JAX side of every SU(3) parity
    test runs under jax.disable_jit() (as tests/test_dynamics.py does)."""
    with jax.disable_jit():
        yield


#: the compiled c1 != 0 force, per (lattice, batch, c1), for the process
_C1_FORCE: dict = {}


@pytest.fixture
def compiled_c1_force(monkeypatch):
    """The JAX package's c1 != 0 force is jax.grad of the improved action:
    op by op a call takes 8-14 s, compiled ~15 s once. A test whose
    trajectories evaluate it several times takes it compiled, one
    executable per (lattice, batch, c1) for the process; every other op
    of the JAX side stays op by op."""
    from l2hmc_tpu.ops import su3_comp as jc
    real = jc.grad_action

    def grad_action(x, beta, lat, nb, roll=None, c1=0.0):
        if c1 == 0.0 or roll is not None:
            return real(x, beta, lat, nb, roll, c1=c1)
        key = (tuple(lat), int(nb), float(c1))
        with jax.disable_jit(False):
            if key not in _C1_FORCE:
                _C1_FORCE[key] = jax.jit(
                    lambda y, b: real(y, b, key[0], key[1], c1=key[2]))
            return _C1_FORCE[key](x, jnp.asarray(beta, jnp.float64))

    monkeypatch.setattr(jc, "grad_action", grad_action)


def su3_fields(nb=2, lat=LAT, seed=0):
    """(x, v) of the JAX package at complex128: Haar links, TAH momenta."""
    from l2hmc_tpu.ops import su3 as jg
    shape = (nb, 4, *lat, 3, 3)
    kx, kv = jax.random.split(jax.random.PRNGKey(seed))
    return (jg.random(kx, shape, dtype=jnp.complex128),
            jg.random_momentum(kv, shape, dtype=jnp.complex128))


def momentum_draws(key, base) -> torch.Tensor:
    """The eight normal draws `su3.random_momentum(key, (*base, 3, 3))`
    makes, stacked (8, *base) in its order (r3, r8, r01, r02, r12, i01,
    i02, i12)."""
    ks = jax.random.split(key, 8)
    return to_torch(jnp.stack([jax.random.normal(k, base, dtype=jnp.float64)
                               for k in ks]))


def make_su3(nlf=1, lat=LAT, nchains=2, units=(4,), eps=0.05, c1=0.0,
             verbose=False, seed=1):
    """(JAX dynamics, params, masks, port dynamics) for SU(3) at
    complex128. The step sizes are spread per step, so that a mix-up of
    step indices would show."""
    from l2hmc_tpu.configs import DynamicsConfig, NetworkConfig
    from l2hmc_tpu.models.dynamics import Dynamics
    cfg = DynamicsConfig(nchains=nchains, group="SU3", latvolume=list(lat),
                         nleapfrog=nlf, eps=eps, merge_directions=True,
                         verbose=verbose)
    netcfg = NetworkConfig(units=list(units), activation_fn="tanh",
                           dropout_prob=0.0, use_batch_norm=False)
    dyn = Dynamics(cfg, netcfg, dtype=jnp.complex128, c1=c1)
    # the initial weights are an input of every comparison: jitted, they
    # are ready in a second, where op by op they take several
    with jax.disable_jit(False):
        params, masks = jax.jit(dyn.init_params)(jax.random.PRNGKey(seed))
    spread = jnp.linspace(0.0, 0.3, nlf)
    params = params._replace(xeps=params.xeps + spread,
                             veps=params.veps - spread)
    return dyn, params, masks, port_dynamics(dyn, params, masks)


def comp_np(f) -> tuple:
    """A component field of either package as two (3, 3, L) numpy arrays."""
    return (np.asarray(grab_any(f.re)).reshape(3, 3, -1),
            np.asarray(grab_any(f.im)).reshape(3, 3, -1))


def grab_any(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def grad_pairs(tdyn, jtree, attr="grad"):
    """(name, port tensor, JAX array in the torch layout) for every
    parameter of the port's Dynamics and the matching leaf of a JAX tree
    shaped like DynamicsParams (gradients, Adam moments or the params
    themselves): `attr` "grad" reads each parameter's .grad, None the
    parameter. Stacks that one side lacks (SU(3) has no xnets) are
    skipped, as are BN and conv leaves where the nets have none."""
    def pick(p):
        return getattr(p, attr) if attr else p

    yield "xeps", pick(tdyn.xeps), np.asarray(jtree.xeps)
    yield "veps", pick(tdyn.veps), np.asarray(jtree.veps)
    sep = tdyn.config.use_separate_networks
    for name in ("vnets", "xnets_first", "xnets_second"):
        tree, stack = getattr(jtree, name), getattr(tdyn, name)
        if stack is None:
            assert tree is None, name
            continue
        for i, layer in enumerate(stack):
            def g(*path):
                a = tree
                for p in path:
                    a = a[p]
                a = np.asarray(a)
                return a[i] if sep else a
            lins = [(ln, getattr(layer, ln), (ln,)) for ln in
                    ("xlayer", "vlayer", "scale", "transl", "transf")]
            lins += [(f"hidden{h}", lin, ("hidden", h))
                     for h, lin in enumerate(layer.hidden)]
            if layer.conv is not None:
                lins.append(("conv.head", layer.conv.head, ("conv", "head")))
                for c, cl in enumerate(layer.conv.layers):
                    yield (f"{name}{i}.conv{c}.w", pick(cl.weight),
                           g("conv", "layers", c, "w"))
                    yield (f"{name}{i}.conv{c}.b", pick(cl.bias),
                           g("conv", "layers", c, "b"))
            for ln, lin, path in lins:
                yield f"{name}{i}.{ln}.w", pick(lin.weight), g(*path, "w").T
                yield f"{name}{i}.{ln}.b", pick(lin.bias), g(*path, "b")
            for ln in ("scale", "transf"):
                yield (f"{name}{i}.{ln}.coeff", pick(getattr(layer, ln).coeff),
                       g(ln, "coeff"))
            if layer.bn is not None:
                for ln in ("gamma", "beta"):
                    yield (f"{name}{i}.bn.{ln}", pick(getattr(layer.bn, ln)),
                           g("bn", ln))
