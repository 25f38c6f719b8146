"""Generalized-leapfrog (L2HMC) dynamics for 2D U(1), and plain HMC.

PyTorch counterpart of the U(1) branch of the JAX package's
`models/dynamics.py` (after the reference's
src/l2hmc/dynamics/pytorch/dynamics.py). Update equations:

  v-update fwd (dynamics.py:1266-1280):
      eps = sigmoid(raw_veps[k])
      (s,t,q) = vnet(x, F),   F = dS/dx
      logjac = eps*s/2;  v' = exp(logjac)*v - eps/2*(F*exp(eps*q) + t)
  x-update fwd, U(1) NCP (dynamics.py:1386-1419):
      (s,t,q) = xnet([cos,sin](m*x), v);  s,q *= eps
      x' = 2 atan(tan(x/2) exp(s)) + eps*(v exp(q) + t)
      xf = m*x + (1-m)*x'
  backward updates are the exact inverses (the x-update's is the true
  inverse, not the reference's approximate one).

Step sizes are raw parameters consumed as sigmoid(raw), raw = log(eps0).

Force caching: the force needed by the first v-half-kick of step k+1
equals the one computed for the second half-kick of step k, so each
direction takes nlf+1 force evaluations. Every force evaluation goes
through `LatticeU1.grad_action`, i.e. the fused force kernel on the card.
In training each leapfrog step is recomputed in the backward pass
(`torch.utils.checkpoint`, the counterpart of `jax.checkpoint`).

Randomness: every function that consumes it also accepts its draws as
tensors — momenta `v`, MH uniforms `u`, dropout masks, the initial x — and
without them samples from the `torch.Generator` it is given. The dropout
masks of one trajectory are one bool tensor (8*nlf, nb, units[-1]); the
call j (0..3) of step k in direction d uses row k*8 + j + (4 if d < 0),
the index the JAX package folds into its dropout key.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from l2hmc_torch.configs import (
    ConvolutionConfig, DynamicsConfig, NetWeights, NetworkConfig,
)
from l2hmc_torch.models.networks import LeapfrogLayer, index_tree
from l2hmc_torch.ops import lattice_u1
from l2hmc_torch.ops import u1 as u1g
from l2hmc_torch.utils import mh


class State(NamedTuple):
    x: torch.Tensor
    v: torch.Tensor
    beta: float


class MonteCarloStates(NamedTuple):
    init: State
    proposed: State
    out: State


def _tree_get(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


class Dynamics(nn.Module):
    """Trainable step sizes, per-step (s, t, q) networks and the fixed
    per-step masks (a buffer), with the transition kernels as methods."""

    def __init__(
        self,
        config: DynamicsConfig,
        network: NetworkConfig,
        net_weights: Optional[NetWeights] = None,
        conv: Optional[ConvolutionConfig] = None,
        dtype=torch.float32,
        net_compute_dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if config.group != "U1":
            raise NotImplementedError(
                f"group={config.group} is not ported to l2hmc_torch yet "
                "(only U1)")
        if conv is not None and conv.filters:
            raise NotImplementedError(
                "the U(1) conv front-end (conv.filters) is not ported to "
                "l2hmc_torch yet")
        if config.verbose:
            raise NotImplementedError(
                "dynamics.verbose (per-leapfrog series) is not ported to "
                "l2hmc_torch yet")
        self.config = config
        self.network_config = network
        self.net_weights = net_weights or NetWeights()
        self.nlf = config.nleapfrog
        self.dtype = dtype
        self.lattice = lattice_u1.LatticeU1(config.nchains,
                                            list(config.latvolume))
        self.xdim = config.xdim

        raw = math.log(config.eps)
        self.xeps = nn.Parameter(torch.full((self.nlf,), raw, dtype=dtype))
        self.veps = nn.Parameter(torch.full((self.nlf,), raw, dtype=dtype))
        n_copies = self.nlf if config.use_separate_networks else 1

        def stack(x_dim, nw):
            return nn.ModuleList(
                LeapfrogLayer(x_dim, self.xdim, self.xdim, network, nw,
                              dtype=dtype, compute_dtype=net_compute_dtype)
                for _ in range(n_copies))

        self.vnets = stack(self.xdim, self.net_weights.v)
        # the x networks see x as [cos, sin]
        self.xnets_first = stack(2 * self.xdim, self.net_weights.x)
        self.xnets_second = (stack(2 * self.xdim, self.net_weights.x)
                             if config.use_split_xnets else None)
        self.register_buffer("masks",
                             torch.zeros((self.nlf, self.xdim), dtype=dtype))
        self.init_params(generator)

    # ------------------------------------------------------------------
    # Initialization and weights from the JAX package
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None):
        """Step sizes at log(eps), fresh network weights and masks, drawn
        from `generator` (a CPU generator while the module is on the
        CPU)."""
        raw = math.log(self.config.eps)
        self.xeps.fill_(raw)
        self.veps.fill_(raw)
        for stack in (self.vnets, self.xnets_first, self.xnets_second):
            for layer in (stack or ()):
                layer.reset_parameters(generator)
        self.masks.copy_(self._build_masks(generator))

    def _build_masks(self, generator=None) -> torch.Tensor:
        """Per-step random binary masks, half the dof active
        (dynamics.py:1101-1110). Shape (nlf, xdim)."""
        rows = []
        for _ in range(self.nlf):
            perm = torch.randperm(self.xdim, generator=generator,
                                  device=self.masks.device)
            mask = torch.zeros(self.xdim, dtype=self.dtype,
                               device=self.masks.device)
            mask[perm[: self.xdim // 2]] = 1.0
            rows.append(mask)
        return torch.stack(rows)

    @torch.no_grad()
    def load_jax_params(self, params, masks=None) -> None:
        """Copy the JAX package's DynamicsParams (a tree of numpy arrays:
        raw xeps/veps, nets stacked on the leapfrog axis when
        use_separate_networks, BN running statistics) and its masks into
        this module."""
        self.xeps.copy_(torch.from_numpy(np.array(_tree_get(params, "xeps"))))
        self.veps.copy_(torch.from_numpy(np.array(_tree_get(params, "veps"))))
        sep = self.config.use_separate_networks
        for name in ("vnets", "xnets_first", "xnets_second"):
            stack = getattr(self, name)
            tree = _tree_get(params, name)
            if stack is None:
                continue
            for i, layer in enumerate(stack):
                layer.load_jax_params(index_tree(tree, i) if sep else tree)
        if masks is not None:
            self.masks.copy_(torch.from_numpy(np.array(masks)))

    def _nets(self, k: int):
        i = k if self.config.use_separate_networks else 0
        xnet0 = self.xnets_first[i]
        xnet1 = (self.xnets_second[i] if self.config.use_split_xnets
                 else xnet0)
        return self.vnets[i], xnet0, xnet1

    # ------------------------------------------------------------------
    # Physics helpers
    # ------------------------------------------------------------------
    def potential(self, x, beta):
        return self.lattice.action(x, beta)

    def grad_potential(self, x, beta):
        return self.lattice.grad_action(x, beta)

    def kinetic_energy(self, v):
        return self.lattice.kinetic_energy(v)

    def hamiltonian(self, state: State) -> torch.Tensor:
        return self.kinetic_energy(state.v) + self.potential(state.x,
                                                             state.beta)

    def random_x(self, generator=None, nchains: Optional[int] = None):
        n = nchains or self.config.nchains
        dev = self.xeps.device
        if getattr(self.config, "cold_start", False):
            return torch.zeros((n, self.xdim), dtype=self.dtype, device=dev)
        return u1g.random((n, self.xdim), generator, self.dtype, dev)

    def random_v(self, x, generator=None):
        return u1g.random_momentum(x.shape, generator, x.dtype, x.device)

    def _dropout_on(self, training: bool) -> bool:
        return bool(training) and self.network_config.dropout_prob > 0

    def random_dropout_masks(self, nb: int, generator=None) -> torch.Tensor:
        """All dropout masks of one trajectory, (8*nlf, nb, units[-1])."""
        keep = 1.0 - self.network_config.dropout_prob
        shape = (8 * self.nlf, nb, int(self.network_config.units[-1]))
        u = torch.rand(shape, generator=generator, dtype=self.dtype,
                       device=self.xeps.device)
        return u < keep

    # ------------------------------------------------------------------
    # Network calls
    # ------------------------------------------------------------------
    def _collect_bn(self, training) -> bool:
        return bool(training) and self.network_config.use_batch_norm \
            and self.network_config.bn_track_running_stats

    def _call_vnet(self, vnet, x, force, training, dmask):
        """(x, F) -> (s, t, q) (dynamics.py:1142-1159)."""
        nb = x.shape[0]
        return vnet(x.reshape(nb, -1), force.reshape(nb, -1),
                    training=training, dropout_mask=dmask,
                    collect_bn=self._collect_bn(training))

    def _call_xnet(self, xnet, xm, v, training, dmask):
        """(m*x, v) -> (s, t, q); U(1) x rep is [cos, sin]
        (dynamics.py:1161-1185)."""
        nb = xm.shape[0]
        xin = torch.cat([torch.cos(xm), torch.sin(xm)], dim=-1)
        return xnet(xin, v.reshape(nb, -1), training=training,
                    dropout_mask=dmask, collect_bn=self._collect_bn(training))

    # ------------------------------------------------------------------
    # Single updates
    # ------------------------------------------------------------------
    def _update_v(self, vnet, state: State, force, eps, direction: int,
                  training, dmask):
        """Forward (direction=+1) or backward (-1) v update. Returns
        (v', logdet, bn)."""
        out = self._call_vnet(vnet, state.x, force, training, dmask)
        s, t, q = out[:3]
        bn = out[3] if len(out) == 4 else None
        jac = 0.5 * eps * s
        logjac = jac if direction > 0 else -jac
        logdet = torch.sum(logjac, dim=1)
        exp_s = torch.exp(logjac)
        exp_q = torch.exp(eps * q)
        force_new = force * exp_q + t
        if direction > 0:
            vf = exp_s * state.v - 0.5 * eps * force_new
        else:
            vf = exp_s * (state.v + 0.5 * eps * force_new)
        return vf, logdet, bn

    def _update_x_u1(self, xnet, state: State, m, eps, direction: int,
                     training, dmask):
        """U(1) x update. Forward (NCP): x' = 2 atan(tan(x/2) e^s) +
        eps (v e^q + t); backward: its exact inverse
        x = 2 atan(e^{-s} tan((x'-B)/2)), B = eps (v e^q + t)."""
        mb = 1.0 - m
        xm = m * state.x
        out = self._call_xnet(xnet, xm, state.v, training, dmask)
        s, t, q = out[:3]
        bn = out[3] if len(out) == 4 else None
        s = eps * s
        q = eps * q
        exp_q = torch.exp(q)
        b = eps * (state.v * exp_q + t)
        if self.config.use_ncp:
            if direction > 0:
                exp_s = torch.exp(s)
                half = 0.5 * state.x
                xp = 2.0 * torch.atan(torch.tan(half) * exp_s) + b
            else:
                exp_s = torch.exp(-s)
                half = 0.5 * (state.x - b)
                xp = 2.0 * torch.atan(torch.tan(half) * exp_s)
            cterm = torch.square(torch.cos(half))
            sterm = torch.square(exp_s * torch.sin(half))
            logdet_ = torch.log(exp_s / (cterm + sterm))
            logdet = torch.sum(mb * logdet_, dim=1)
        else:
            if direction > 0:
                xp = state.x * torch.exp(s) + b
                logdet = torch.sum(mb * s, dim=1)
            else:
                xp = torch.exp(-s) * (state.x - b)
                logdet = torch.sum(mb * (-s), dim=1)
        xf = xm + mb * xp
        return u1g.compat_proj(xf), logdet, bn

    # ------------------------------------------------------------------
    # Leapfrog steps (force carried across the step boundary)
    # ------------------------------------------------------------------
    def _lf_step(self, x, v, force, sumlogdet, beta, k: int, direction: int,
                 training: bool, dropout_masks):
        """One generalized leapfrog step with the parameters of step k
        (fwd: dynamics.py:1187-1206, bwd: :1208-1228). Returns
        (x2, v2, force2, sumlogdet, bn)."""
        eps_x = torch.sigmoid(self.xeps[k])
        eps_v = torch.sigmoid(self.veps[k])
        m = self.masks[k]
        mb = 1.0 - m
        vnet, xnet0, xnet1 = self._nets(k)

        def dmask(j):
            if dropout_masks is None or not self._dropout_on(training):
                return None
            return dropout_masks[k * 8 + j + (4 if direction < 0 else 0)]

        v1, ld, bn_v0 = self._update_v(vnet, State(x, v, beta), force, eps_v,
                                       direction, training, dmask(0))
        sumlogdet = sumlogdet + ld
        if direction > 0:
            x1, ld, bn_x0 = self._update_x_u1(
                xnet0, State(x, v1, beta), m, eps_x, direction, training,
                dmask(1))
            sumlogdet = sumlogdet + ld
            x2, ld, bn_x1 = self._update_x_u1(
                xnet1, State(x1, v1, beta), mb, eps_x, direction, training,
                dmask(2))
        else:
            # backward order: (1-m) side first (dynamics.py:1222-1225)
            x1, ld, bn_x1 = self._update_x_u1(
                xnet1, State(x, v1, beta), mb, eps_x, direction, training,
                dmask(1))
            sumlogdet = sumlogdet + ld
            x2, ld, bn_x0 = self._update_x_u1(
                xnet0, State(x1, v1, beta), m, eps_x, direction, training,
                dmask(2))
        sumlogdet = sumlogdet + ld
        force2 = self.grad_potential(x2, beta)
        v2, ld, bn_v1 = self._update_v(vnet, State(x2, v1, beta), force2,
                                       eps_v, direction, training, dmask(3))
        sumlogdet = sumlogdet + ld
        bn = None
        if self._collect_bn(training):
            # labelled by NET (x0/x1 = first/second xnet whatever the
            # call order), so the Trainer's EMA lands on the right module
            bn = {"v": (bn_v0, bn_v1), "x0": bn_x0, "x1": bn_x1}
        return x2, v2, force2, sumlogdet, bn

    def _scan_direction(self, x, v, beta, direction: int, training: bool,
                        dropout_masks, sumlogdet):
        """nlf leapfrog steps in one direction (reversed step order for
        direction < 0). Returns (x, v, sumlogdet, [(k, bn), ...])."""
        order = range(self.nlf) if direction > 0 else \
            range(self.nlf - 1, -1, -1)
        force = self.grad_potential(x, beta)
        remat = training and torch.is_grad_enabled()
        bn_stats = []
        for k in order:
            args = (x, v, force, sumlogdet, beta, k, direction, training,
                    dropout_masks)
            if remat:
                # the step draws nothing (its dropout masks are inputs), so
                # the recomputation needs no saved RNG state
                out = checkpoint(self._lf_step, *args, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = self._lf_step(*args)
            x, v, force, sumlogdet, bn = out
            if bn is not None:
                bn_stats.append((k, bn))
        return x, v, sumlogdet, bn_stats

    # ------------------------------------------------------------------
    # Transition kernels
    # ------------------------------------------------------------------
    def transition_kernel_fb(self, state: State, training: bool = False,
                             dropout_masks=None):
        """Merged-direction kernel: nlf forward steps, momentum flip, nlf
        backward steps (dynamics.py:956-1029). Returns
        (proposed state, sumlogdet, metrics)."""
        sld = torch.zeros(state.x.shape[0], dtype=self.dtype,
                          device=state.x.device)
        x, v, sld, bn_f = self._scan_direction(
            state.x, state.v, state.beta, +1, training, dropout_masks, sld)
        x, v, sld, bn_b = self._scan_direction(
            x, -v, state.beta, -1, training, dropout_masks, sld)
        metrics = {"sumlogdet": sld}
        if bn_f or bn_b:
            metrics["bn_stats"] = bn_f + bn_b
        return State(x, v, state.beta), sld, metrics

    def transition_kernel(self, state: State, forward: bool,
                          training: bool = False, dropout_masks=None,
                          with_metrics: bool = False):
        """Single-direction kernel (dynamics.py:1031-1063)."""
        sld = torch.zeros(state.x.shape[0], dtype=self.dtype,
                          device=state.x.device)
        x, v, sld, bn = self._scan_direction(
            state.x, state.v, state.beta, +1 if forward else -1, training,
            dropout_masks, sld)
        st = State(x, v, state.beta)
        if with_metrics:
            return st, sld, ({"bn_stats": bn} if bn else {})
        return st, sld

    def compute_accept_prob(self, state_init: State, state_prop: State,
                            sumlogdet) -> torch.Tensor:
        """acc = exp(min(0, H(init) - H(prop) + sumlogdet))."""
        dh = (self.hamiltonian(state_init) - self.hamiltonian(state_prop)
              + sumlogdet)
        return mh.accept_prob(dh)

    def _mh(self, init: State, prop: State, acc, u, generator):
        if u is None:
            u = torch.rand(acc.shape, generator=generator, dtype=acc.dtype,
                           device=acc.device)
        acc_mask = (acc > u).to(self.dtype)
        x_out = mh.select(acc_mask, prop.x, init.x)
        v_out = mh.select(acc_mask, prop.v, init.v)
        return acc_mask, State(x_out, v_out, init.beta)

    def apply_transition_fb(self, x, beta, generator=None,
                            training: bool = False, v=None, u=None,
                            dropout_masks=None):
        """Full MH transition with the merged kernel (dynamics.py:660-702).
        Returns (x_out, metrics)."""
        if v is None:
            v = self.random_v(x, generator)
        if dropout_masks is None and self._dropout_on(training):
            dropout_masks = self.random_dropout_masks(x.shape[0], generator)
        init = State(x, v, beta)
        prop, sld, kmetrics = self.transition_kernel_fb(
            init, training=training, dropout_masks=dropout_masks)
        acc = self.compute_accept_prob(init, prop, sld)
        acc_mask, out = self._mh(init, prop, acc, u, generator)
        metrics = {
            "acc": acc,
            "acc_mask": acc_mask,
            "sumlogdet": acc_mask * sld,
            "beta": beta,
            "mc_states": MonteCarloStates(init=init, proposed=prop, out=out),
        }
        metrics.update({k: v_ for k, v_ in kmetrics.items()
                        if k != "sumlogdet"})
        return out.x, metrics

    def apply_transition(self, x, beta, generator=None,
                         training: bool = False, forward: Optional[bool] = None,
                         v=None, u=None, dropout_masks=None):
        """Random single-direction transition (dynamics.py:704-742); one
        direction draw for the whole batch."""
        if forward is None:
            forward = bool(torch.rand((), generator=generator,
                                      device=x.device) < 0.5)
        if v is None:
            v = self.random_v(x, generator)
        if dropout_masks is None and self._dropout_on(training):
            dropout_masks = self.random_dropout_masks(x.shape[0], generator)
        init = State(x, v, beta)
        prop, sld, kmetrics = self.transition_kernel(
            init, forward, training=training, dropout_masks=dropout_masks,
            with_metrics=True)
        acc = self.compute_accept_prob(init, prop, sld)
        acc_mask, out = self._mh(init, prop, acc, u, generator)
        metrics = {
            "acc": acc,
            "acc_mask": acc_mask,
            "sumlogdet": acc_mask * sld,
            "beta": beta,
            "mc_states": MonteCarloStates(init=init, proposed=prop, out=out),
        }
        metrics.update(kmetrics)
        return out.x, metrics

    # ------------------------------------------------------------------
    # Plain HMC (network-free baseline; dynamics.py:632-658, 900-954)
    # ------------------------------------------------------------------
    def transition_kernel_hmc(self, state: State, eps, nleapfrog: int):
        """nleapfrog leapfrog steps with force caching (nleapfrog + 1
        force evaluations). Returns (proposed state, dH)."""
        x, v = state.x, state.v
        force = self.grad_potential(x, state.beta)
        for _ in range(nleapfrog):
            v1 = v - 0.5 * eps * force
            x = u1g.update_gauge(x, eps * v1)
            force = self.grad_potential(x, state.beta)
            v = v1 - 0.5 * eps * force
        prop = State(x, v, state.beta)
        dh = self.hamiltonian(state) - self.hamiltonian(prop)
        return prop, dh

    def apply_transition_hmc(self, x, beta, generator=None, eps=None,
                             nleapfrog: Optional[int] = None, v=None, u=None):
        """HMC MH transition (dynamics.py:632-658)."""
        cfg = self.config
        if eps is None:
            eps = cfg.eps_hmc
        if nleapfrog is None:
            nleapfrog = cfg.nleapfrog * (2 if cfg.merge_directions else 1)
        if v is None:
            v = self.random_v(x, generator)
        init = State(x, v, beta)
        prop, dh = self.transition_kernel_hmc(init, eps, nleapfrog)
        acc = mh.accept_prob(dh).to(self.dtype)
        acc_mask, out = self._mh(init, prop, acc, u, generator)
        metrics = {
            "acc": acc,
            "acc_mask": acc_mask,
            "sumlogdet": torch.zeros_like(acc),
            "beta": beta,
            "mc_states": MonteCarloStates(init=init, proposed=prop, out=out),
        }
        return out.x, metrics
