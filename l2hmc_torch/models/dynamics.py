"""Generalized-leapfrog (L2HMC) dynamics for 2D U(1) and 4D SU(3), and
plain HMC.

PyTorch counterpart of the JAX package's `models/dynamics.py` (after the
reference's src/l2hmc/dynamics/pytorch/dynamics.py). Update equations:

  v-update fwd (dynamics.py:1266-1280):
      eps = sigmoid(raw_veps[k])
      (s,t,q) = vnet(x, F),   F = dS/dx
      logjac = eps*s/2;  v' = exp(logjac)*v - eps/2*(F*exp(eps*q) + t)
  x-update fwd, U(1) NCP (dynamics.py:1386-1419):
      (s,t,q) = xnet([cos,sin](m*x), v);  s,q *= eps
      x' = 2 atan(tan(x/2) exp(s)) + eps*(v exp(q) + t)
      xf = m*x + (1-m)*x'
  x-update fwd, SU(3) (dynamics.py:1420-1425):
      xf = m*x + exp(eps*v) @ ((1-m)*x);  logdet += 0
  backward updates are the exact inverses (the U(1) x-update's is the true
  inverse, not the reference's approximate one).

SU(3) runs the whole trajectory in the component engine (ops/su3_comp:
re/im tensors shaped (3, 3, L)); the complex (nb, 4, t, x, y, z, 3, 3)
layout is converted once on the way in and once on the way out. Its
x-update uses no network, its masks are per link, and the merged
trajectory is one Python loop over a step schedule (parameter index,
direction, momentum flip). For the plain Wilson action every force
evaluation also yields the plaquette trace sum, so the MH Hamiltonians
cost no extra plaquette walk.

Step sizes are raw parameters consumed as sigmoid(raw), raw = log(eps0).

Force caching: the force needed by the first v-half-kick of step k+1
equals the one computed for the second half-kick of step k, so each
direction takes nlf+1 force evaluations. Every force evaluation goes
of U(1) goes through `LatticeU1.grad_action`, i.e. the fused force kernel
on the card. In training each U(1) leapfrog step is recomputed in the
backward pass (`torch.utils.checkpoint`, the counterpart of
`jax.checkpoint`); SU(3) steps are not, as in the reference.

Randomness: every function that consumes it also accepts its draws as
tensors — momenta `v`, MH uniforms `u`, dropout masks, the initial x, and
the single-direction transition's direction `forward` — and without them
samples from the `torch.Generator` it is given. beta and the HMC eps may
be 0-d tensors: nothing here reads them on the host, so a CUDA graph of a
step reads them when it is replayed. The dropout
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
from l2hmc_torch.ops import lattice_su3, lattice_u1
from l2hmc_torch.ops import su3 as su3g
from l2hmc_torch.ops import su3_comp as comp
from l2hmc_torch.ops import u1 as u1g
from l2hmc_torch.utils import mh, spans

#: the networks' span (utils/spans.py): their inputs, layers and heads
NETWORKS = spans.span("networks")


class State(NamedTuple):
    x: torch.Tensor
    v: torch.Tensor
    #: a 0-d tensor on the step's path (a graph replays whatever it
    #: holds); a number works everywhere too
    beta: torch.Tensor


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
        c1: float = 0.0,
    ):
        super().__init__()
        self.config = config
        self.c1 = float(c1)
        self.network_config = network
        self.net_weights = net_weights or NetWeights()
        self.conv = conv if (conv and conv.filters) else None
        self.group = config.group
        self.nlf = config.nleapfrog
        self.dtype = dtype
        self.real_dtype = su3g.real_dtype(dtype)
        if self.group == "U1":
            self.lattice = lattice_u1.LatticeU1(config.nchains,
                                                list(config.latvolume))
            self.xdim = config.xdim
            x_in_dim = 2 * self.xdim        # the x networks see [cos, sin]
            v_in_dim = vnet_x_dim = out_dim = self.mask_dim = self.xdim
        else:
            if not dtype.is_complex:
                raise ValueError(f"SU(3) needs a complex dtype, got {dtype}")
            self.lattice = lattice_su3.LatticeSU3(
                config.nchains, list(config.latvolume), c1=self.c1)
            vol = self.lattice.volume
            self.xdim = 4 * vol * 9          # complex entries per config
            # the vnet reads 8 Gell-Mann coordinates per link, and its
            # heads give one real (s, t, q) per complex matrix entry
            x_in_dim = v_in_dim = vnet_x_dim = 4 * vol * 8
            out_dim = 4 * vol * 9
            # per-LINK masks (constant over each 3x3 block): the reference
            # masks individual matrix entries (dynamics.py:1101-1110),
            # which makes its SU(3) x-update non-invertible since the
            # matmul mixes entries within a link
            self.mask_dim = 4 * vol

        rdt = self.real_dtype
        raw = math.log(config.eps)
        self.xeps = nn.Parameter(torch.full((self.nlf,), raw, dtype=rdt))
        self.veps = nn.Parameter(torch.full((self.nlf,), raw, dtype=rdt))
        n_copies = self.nlf if config.use_separate_networks else 1

        def stack(x_dim, nw, with_conv=False):
            conv_args = {}
            if with_conv and self.conv is not None:
                conv_args = dict(conv=self.conv,
                                 conv_channels=2 * config.dim,
                                 conv_hw=(config.nt, config.nx))
            return nn.ModuleList(
                LeapfrogLayer(x_dim, v_in_dim, out_dim, network, nw,
                              dtype=rdt, compute_dtype=net_compute_dtype,
                              **conv_args)
                for _ in range(n_copies))

        self.vnets = stack(vnet_x_dim, self.net_weights.v)
        if self.group == "U1":
            # only the x networks get the conv front-end
            self.xnets_first = stack(x_in_dim, self.net_weights.x, True)
            self.xnets_second = (stack(x_in_dim, self.net_weights.x, True)
                                 if config.use_split_xnets else None)
        else:
            # the reference's SU(3) x-update never calls its xnets
            # (dynamics.py:1420-1425); they are not built
            self.xnets_first = None
            self.xnets_second = None
        self.register_buffer(
            "masks", torch.zeros((self.nlf, self.mask_dim), dtype=rdt))
        #: the networks' batch-norm mean over the batch (None: this
        #: process' chains; the data-parallel trainer sets the mean over
        #: every rank's chains)
        self.batch_mean = None
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
        (dynamics.py:1101-1110). Shape (nlf, mask_dim): one entry per
        U(1) link or per SU(3) link."""
        rows = []
        for _ in range(self.nlf):
            perm = torch.randperm(self.mask_dim, generator=generator,
                                  device=self.masks.device)
            mask = torch.zeros(self.mask_dim, dtype=self.real_dtype,
                               device=self.masks.device)
            mask[perm[: self.mask_dim // 2]] = 1.0
            rows.append(mask)
        return torch.stack(rows)

    @torch.no_grad()
    def load_jax_params(self, params, masks=None) -> None:
        """Copy the JAX package's DynamicsParams (a tree of numpy arrays:
        raw xeps/veps, nets stacked on the leapfrog axis when
        use_separate_networks, BN running statistics; the xnets are None
        for SU(3)) and its masks into this module."""
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
        if self.group == "SU3":
            return self.vnets[i], None, None
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
        """Total energy; SU(3) computes through the component engine."""
        if self.group == "SU3":
            return self._hamiltonian_internal(
                comp.from_complex_lattice(state.x),
                comp.from_complex_lattice(state.v), state.beta)
        return self.kinetic_energy(state.v) + self.potential(state.x,
                                                             state.beta)

    def random_x(self, generator=None, nchains: Optional[int] = None):
        """A hot (Haar / uniform) start, or with config.cold_start the
        ordered one: identity links / zero phases, the standard choice in
        the ordered phase."""
        n = nchains or self.config.nchains
        dev = self.xeps.device
        cold = getattr(self.config, "cold_start", False)
        if self.group == "U1":
            if cold:
                return torch.zeros((n, self.xdim), dtype=self.dtype,
                                   device=dev)
            return u1g.random((n, self.xdim), generator, self.dtype, dev)
        shape = (n, *self.config.xshape[1:])
        if cold:
            eye = torch.eye(3, dtype=self.dtype, device=dev)
            return eye.expand(shape).clone()
        return su3g.random(shape, generator, self.dtype, dev)

    def random_v(self, x, generator=None):
        if self.group == "U1":
            return u1g.random_momentum(x.shape, generator, x.dtype, x.device)
        return su3g.random_momentum(x.shape, generator, x.dtype, x.device)

    # ------------------------------------------------------------------
    # SU(3) internal representation: the component engine
    # ------------------------------------------------------------------
    def _lat(self):
        return tuple(self.config.latvolume)

    def _comp_nb(self, f: "comp.F3") -> int:
        """Chain count from the flat component length (eval runs with
        fewer chains than config.nchains)."""
        return comp.batch_size(f) // (4 * self.lattice.volume)

    def _x_from_comp(self, f: "comp.F3") -> torch.Tensor:
        return comp.to_complex_lattice(f, self._lat(), self._comp_nb(f),
                                       self.dtype)

    def _force_traces_internal(self, ix, beta):
        """(force, plaq_re_sum or None): the Wilson force computation
        yields the action trace for free (comp.force_and_traces), so the
        kernels reuse it for the MH Hamiltonians. c1 != 0 has no such
        sharing and gives (autograd force, None)."""
        nb = self._comp_nb(ix)
        if self.c1 != 0.0:
            return comp.grad_action(ix, beta, self._lat(), nb,
                                    c1=self.c1), None
        return comp.force_and_traces(ix, beta, self._lat(), nb)

    def _h_from_traces(self, iv, beta, tr):
        return comp.kinetic_energy(iv, self._comp_nb(iv)) \
            + (-beta / 3.0) * tr

    def _hamiltonian_internal(self, ix, iv, beta) -> torch.Tensor:
        nb = self._comp_nb(ix)
        return (comp.kinetic_energy(iv, nb)
                + comp.action(ix, beta, self._lat(), nb, c1=self.c1))

    def _vec_flatten(self, coords: torch.Tensor) -> torch.Tensor:
        """(8, L) coordinates (L = 4*V*nb in (d, lat, nb) order) ->
        (nb, 8*4*V) in the (8, d, t, x, y, z) feature order the vnet was
        initialized with."""
        nb = coords.shape[1] // (4 * self.lattice.volume)
        return coords.reshape(8, -1, nb).permute(2, 0, 1).reshape(nb, -1)

    def _stq_to_comp(self, a: torch.Tensor) -> torch.Tensor:
        """Real head output (nb, 4*vol*9) -> (3, 3, L) per-entry field
        (one transpose; L ordered (d, lat, nb))."""
        nb = a.shape[0]
        return a.reshape(nb, -1, 3, 3).permute(2, 3, 1, 0).reshape(3, 3, -1)

    def _dropout_on(self, training: bool) -> bool:
        return bool(training) and self.network_config.dropout_prob > 0

    def random_dropout_masks(self, nb: int, generator=None) -> torch.Tensor:
        """All dropout masks of one trajectory, (8*nlf, nb, units[-1])."""
        keep = 1.0 - self.network_config.dropout_prob
        shape = (8 * self.nlf, nb, int(self.network_config.units[-1]))
        u = torch.rand(shape, generator=generator, dtype=self.real_dtype,
                       device=self.xeps.device)
        return u < keep

    # ------------------------------------------------------------------
    # Network calls
    # ------------------------------------------------------------------
    def _collect_bn(self, training) -> bool:
        return bool(training) and self.network_config.use_batch_norm \
            and self.network_config.bn_track_running_stats

    @NETWORKS
    def _call_vnet(self, vnet, x, force, training, dmask):
        """(x, F) -> (s, t, q) (dynamics.py:1142-1159).

        SU(3) inputs arrive as component fields and are mapped to 8
        Gell-Mann coordinates per link. The reference's group_to_vec
        applies projectSU before extracting coordinates
        (group/su3/pytorch/group.py:138-147); here they are read directly:
        for x (kept on the group by the per-link masked update) the
        projection is a numerical no-op, and for the force (already TAH,
        which su3_to_vec is defined for) it is an ill-conditioned
        renormalization whose backward is NaN at unitary input."""
        if self.group == "U1":
            nb = x.shape[0]
            xin, fin = x.reshape(nb, -1), force.reshape(nb, -1)
        else:
            xin = self._vec_flatten(comp.su3_to_vec(x))
            fin = self._vec_flatten(comp.su3_to_vec(force))
        return vnet(xin, fin, training=training, dropout_mask=dmask,
                    collect_bn=self._collect_bn(training),
                    mean_fn=self.batch_mean)

    @NETWORKS
    def _call_xnet(self, xnet, xm, v, training, dmask):
        """(m*x, v) -> (s, t, q); U(1) x rep is [cos, sin]
        (dynamics.py:1161-1185)."""
        nb = xm.shape[0]
        xin = torch.cat([torch.cos(xm), torch.sin(xm)], dim=-1)
        return xnet(xin, v.reshape(nb, -1), training=training,
                    dropout_mask=dmask, collect_bn=self._collect_bn(training),
                    mean_fn=self.batch_mean)

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

    def _update_v_su3(self, vnet, x: "comp.F3", v: "comp.F3",
                      force: "comp.F3", eps, direction: int, training,
                      dmask):
        """Component-engine SU(3) v update, the equations of _update_v
        (dynamics.py:1266-1297) with s, t, q real per-entry fields:
            fwd  v' = e^{jac} v - eps/2 G,   bwd  v' = e^{-jac} (v + eps/2 G)
        i.e. v' = exp_s v + w G with exp_s = e^{direction jac} and
        w = -eps/2 (fwd) or +eps/2 exp_s (bwd).

        Jacobian convention: sumlogdet counts eps*s/2 ONCE per complex
        matrix entry (9 per link), the reference's convention
        (dynamics.py:1278 sums the s tensor, one element per complex
        entry), although exp_s scales both the real and the imaginary
        part. A deliberate parity choice, not an independent derivation."""
        out = self._call_vnet(vnet, x, force, training, dmask)
        s, t, q = out[:3]
        bn = out[3] if len(out) == 4 else None
        jac = 0.5 * eps * s
        logjac = jac if direction > 0 else -jac
        logdet = torch.sum(logjac, dim=1)
        exp_s = self._stq_to_comp(torch.exp(logjac))
        exp_q = self._stq_to_comp(torch.exp(eps * q))
        t_ = self._stq_to_comp(t)
        fn_re = force.re * exp_q + t_
        fn_im = force.im * exp_q
        half = 0.5 * eps
        w = -half if direction > 0 else half * exp_s
        vf = comp.F3(exp_s * v.re + w * fn_re, exp_s * v.im + w * fn_im)
        return vf, logdet, bn

    def _update_x_su3(self, x: "comp.F3", v: "comp.F3", m, eps,
                      direction: int, drift: Optional["comp.F3"] = None):
        """SU(3) x update: masked gauge drift, zero logdet
        (dynamics.py:1420-1425, :1468-1475; left translation preserves the
        Haar measure). The per-link mask broadcasts over the 3x3 block, so
        exp(eps v) @ ((1-m) x) touches exactly the (1-m) links and the
        update inverts exactly. Returns (x', drift): the drift
        exp(direction eps v) is shared by both half-updates of a step.

        eps is trainable (sigmoid-bounded < 1) and |v|_F ~ 2.8 for thermal
        TAH momenta, so |eps v|_F can reach ~2.8; two scaling-squaring
        halvings keep the order-8 Taylor unitary to ~4e-8 over that range.

        `reunit` after every sub-update (the reference's compat_proj,
        dynamics.py:1419, :1467): the v-update's entrywise exp_s scaling
        leaves v slightly off the algebra once training turns s on, so the
        drift is only near-unitary, and without this the deviation
        compounds per accepted trajectory. reunit is an exact fixed point
        on unitary links, so the masked links are preserved exactly, and
        unlike projectSU its backward is finite at x†x ~ I."""
        nb = self._comp_nb(x)
        # m: (4*vol,) per link -> flat (4*vol*nb,) in (link, nb) order
        mflat = m[:, None].expand(m.shape[0], nb).reshape(-1)
        mb = 1.0 - mflat
        if drift is None:
            sign = eps if direction > 0 else -eps
            drift = comp.expm(comp.scale(v, sign), order=8, s=2)
        upd = comp.mm(drift, comp.F3(mb * x.re, mb * x.im))
        xf = comp.F3(mflat * x.re + upd.re, mflat * x.im + upd.im)
        return comp.reunit(xf), drift

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
        series = []
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
            if self.config.verbose:
                with torch.no_grad():
                    series.append((self.hamiltonian(State(x, v, beta)),
                                   sumlogdet.detach()))
        return x, v, sumlogdet, bn_stats, series

    @staticmethod
    def _per_step(series) -> dict:
        """The verbose per-leapfrog series, (steps, nb) each: the energy,
        the running logdet and logprob = energy - logdet after every
        step."""
        h = torch.stack([e for e, _ in series])
        ld = torch.stack([s for _, s in series])
        return {"energy": h, "logdet": ld, "logprob": h - ld}

    def _su3_lf_step(self, x, v, force, tr, sumlogdet, beta, k: int,
                     direction: int, training: bool, dropout_masks):
        """One SU(3) generalized leapfrog step with the parameters of step
        k. Backward steps act on the complement side first: the order swap
        is folded into the mask (m fwd, 1 - m bwd)."""
        eps_x = torch.sigmoid(self.xeps[k])
        eps_v = torch.sigmoid(self.veps[k])
        m1 = self.masks[k] if direction > 0 else 1.0 - self.masks[k]
        vnet = self._nets(k)[0]

        def dmask(j):
            if dropout_masks is None or not self._dropout_on(training):
                return None
            return dropout_masks[k * 8 + j + (4 if direction < 0 else 0)]

        v1, ld, bn_v0 = self._update_v_su3(vnet, x, v, force, eps_v,
                                           direction, training, dmask(0))
        sumlogdet = sumlogdet + ld
        # both masked half-updates share the same exp(d eps v1)
        x1, drift = self._update_x_su3(x, v1, m1, eps_x, direction)
        x2, _ = self._update_x_su3(x1, v1, 1.0 - m1, eps_x, direction,
                                   drift=drift)
        force2, tr2 = self._force_traces_internal(x2, beta)
        if tr2 is None:
            tr2 = tr
        v2, ld, bn_v1 = self._update_v_su3(vnet, x2, v1, force2, eps_v,
                                           direction, training, dmask(3))
        sumlogdet = sumlogdet + ld
        bn = {"v": (bn_v0, bn_v1)} if self._collect_bn(training) else None
        return x2, v2, force2, tr2, sumlogdet, bn

    def _su3_scan(self, state: State, sld, schedule, training: bool,
                  dropout_masks):
        """The SU(3) trajectory over a step schedule of (parameter index,
        direction, flip): flip reverses the momentum before the step (the
        midpoint of the merged trajectory, dynamics.py:1001). Returns
        (x, v, sumlogdet, bn_stats, series, tr0, tr_last) with x, v
        component fields."""
        ix = comp.from_complex_lattice(state.x)
        iv = comp.from_complex_lattice(state.v)
        beta = state.beta
        force, tr0 = self._force_traces_internal(ix, beta)
        if tr0 is None:   # c1 != 0: no trace sharing
            tr0 = sld.new_zeros(sld.shape)
        tr = tr0
        bn_stats, series = [], []
        for k, direction, flip in schedule:
            if flip:
                iv = comp.scale(iv, -1.0)
            ix, iv, force, tr, sld, bn = self._su3_lf_step(
                ix, iv, force, tr, sld, beta, k, direction, training,
                dropout_masks)
            if bn is not None:
                bn_stats.append((k, bn))
            if self.config.verbose:
                with torch.no_grad():
                    h = (self._h_from_traces(iv, beta, tr)
                         if self.c1 == 0.0
                         else self._hamiltonian_internal(ix, iv, beta))
                    series.append((h, sld.detach()))
        return ix, iv, sld, bn_stats, series, tr0, tr

    def _schedule(self, forward: Optional[bool]):
        """Step schedule of the merged kernel (forward=None) or of one
        direction."""
        nlf = self.nlf
        fwd = [(k, +1, False) for k in range(nlf)]
        bwd = [(k, -1, False) for k in reversed(range(nlf))]
        if forward is None:
            bwd[0] = (bwd[0][0], -1, True)
            return fwd + bwd
        return fwd if forward else bwd

    # ------------------------------------------------------------------
    # Transition kernels
    # ------------------------------------------------------------------
    def transition_kernel_fb(self, state: State, training: bool = False,
                             dropout_masks=None):
        """Merged-direction kernel: nlf forward steps, momentum flip, nlf
        backward steps (dynamics.py:956-1029). Returns
        (proposed state, sumlogdet, metrics)."""
        sld = torch.zeros(state.x.shape[0], dtype=self.real_dtype,
                          device=state.x.device)
        beta = state.beta
        if self.group == "SU3":
            ix, iv, sld, bn, series, tr0, tr1 = self._su3_scan(
                state, sld, self._schedule(None), training, dropout_masks)
            metrics = {"sumlogdet": sld}
            if self.c1 == 0.0:
                # the force evaluations at the trajectory's ends carry the
                # action traces: the MH Hamiltonians are free
                metrics["h_init_partial"] = (-beta / 3.0) * tr0
                metrics["h_prop"] = self._h_from_traces(iv, beta, tr1)
            self._split_ys(metrics, series, bn)
            prop = State(self._x_from_comp(ix), self._x_from_comp(iv), beta)
            return prop, sld, metrics
        x, v, sld, bn_f, ser_f = self._scan_direction(
            state.x, state.v, beta, +1, training, dropout_masks, sld)
        x, v, sld, bn_b, ser_b = self._scan_direction(
            x, -v, beta, -1, training, dropout_masks, sld)
        metrics = {"sumlogdet": sld}
        self._split_ys(metrics, ser_f + ser_b, bn_f + bn_b)
        return State(x, v, beta), sld, metrics

    def _split_ys(self, metrics: dict, series, bn_stats) -> None:
        """Route the per-leapfrog verbose series to metrics['per_step']
        and the collected BN batch statistics to metrics['bn_stats'] (the
        Trainer's running-statistics EMA reads them)."""
        if self.config.verbose and series:
            metrics["per_step"] = self._per_step(series)
        if bn_stats:
            metrics["bn_stats"] = bn_stats

    def transition_kernel(self, state: State, forward: bool,
                          training: bool = False, dropout_masks=None,
                          with_metrics: bool = False):
        """Single-direction kernel (dynamics.py:1031-1063)."""
        sld = torch.zeros(state.x.shape[0], dtype=self.real_dtype,
                          device=state.x.device)
        if self.group == "SU3":
            ix, iv, sld, bn, series, _, _ = self._su3_scan(
                state, sld, self._schedule(bool(forward)), training,
                dropout_masks)
            x, v = self._x_from_comp(ix), self._x_from_comp(iv)
        else:
            x, v, sld, bn, series = self._scan_direction(
                state.x, state.v, state.beta, +1 if forward else -1,
                training, dropout_masks, sld)
        st = State(x, v, state.beta)
        if with_metrics:
            metrics = {}
            self._split_ys(metrics, series, bn)
            return st, sld, metrics
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
        acc_mask = (acc > u).to(self.real_dtype)
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
        if "h_prop" in kmetrics:
            # traces carried out of the trajectory: only the initial
            # kinetic energy remains to compute
            iv0 = comp.from_complex_lattice(v)
            h_init = (comp.kinetic_energy(iv0, self._comp_nb(iv0))
                      + kmetrics.pop("h_init_partial"))
            acc = mh.accept_prob(h_init - kmetrics.pop("h_prop") + sld)
        else:
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
        force evaluations). Returns (proposed state, dH, plaqs): SU(3)
        runs in the component engine, whose force evaluations give the
        plaquette traces of the initial and the proposed state for free,
        returned as the average plaquettes (Re tr P / 3) of both; None
        for U(1)."""
        if self.group == "SU3":
            lat = self._lat()
            nb = state.x.shape[0]
            xp, vp, dh, (tr0, tr1) = comp.hmc_trajectory(
                comp.from_complex_lattice(state.x),
                comp.from_complex_lattice(state.v), state.beta, eps,
                nleapfrog, lat, nb, c1=self.c1, with_traces=True)
            x = comp.to_complex_lattice(xp, lat, nb, state.x.dtype)
            v = comp.to_complex_lattice(vp, lat, nb, state.v.dtype)
            norm = 6.0 * 3.0 * self.lattice.volume
            return State(x, v, state.beta), dh, (tr0 / norm, tr1 / norm)
        x, v = state.x, state.v
        force = self.grad_potential(x, state.beta)
        for _ in range(nleapfrog):
            v1 = v - 0.5 * eps * force
            x = u1g.update_gauge(x, eps * v1)
            force = self.grad_potential(x, state.beta)
            v = v1 - 0.5 * eps * force
        prop = State(x, v, state.beta)
        dh = self.hamiltonian(state) - self.hamiltonian(prop)
        return prop, dh, None

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
        prop, dh, plaqs = self.transition_kernel_hmc(init, eps, nleapfrog)
        acc = mh.accept_prob(dh).to(self.real_dtype)
        acc_mask, out = self._mh(init, prop, acc, u, generator)
        metrics = {
            "acc": acc,
            "acc_mask": acc_mask,
            "sumlogdet": torch.zeros_like(acc),
            "beta": beta,
            "mc_states": MonteCarloStates(init=init, proposed=prop, out=out),
        }
        if plaqs is not None:
            # plaquettes of the init and the OUT (MH-selected) states
            metrics["plaqs"] = plaqs[0]
            metrics["plaqs_out"] = (acc_mask * plaqs[1]
                                    + (1.0 - acc_mask) * plaqs[0])
        return out.x, metrics
