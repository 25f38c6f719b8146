"""Lattice-sharded L2HMC training for SU(3): the trainable kernel (network
calls, masked gauge updates, loss, gradients) over a (data, lattice)
mesh of ranks; the optimizer step is the routing Trainer's.

PyTorch counterpart of the JAX package's `parallel/sharded_train.py`;
extends `parallel/lattice_sharded.py` (action, force, plain HMC) to the
generalized-leapfrog kernel. A rank holds its block of the field: its
chains (over 'data') and its t rows (over 'lattice'), and runs the
kernel of `models/dynamics.Dynamics` on that block.

The network is the only part that couples lattice sites non-locally:
  * input layers — row-sharded: each rank multiplies its block's
    coordinates by the matching columns of the (replicated) weights, and
    an all-reduce over the lattice group reassembles the activation;
  * hidden stack — replicated (the units are few: cheaper than any
    communication);
  * heads — column-sharded: each rank computes the (s, t, q) of its own
    links only, with no communication;
  * logdet — a local sum and an all-reduce over the lattice group.
Every other map is per link, or goes through the halo roll.

Gradients. Every lattice reduction inside the differentiated step is an
all-reduce whose backward is the same sum (`Mesh.all_reduce(...,
autograd=True)`). Each rank backpropagates its chain-mean loss divided by
the lattice group's size; summed over all ranks that is the data
group's size times the global loss, so the parameter gradients are
summed over both axes and divided by the data axis' size: every path
from a parameter to the loss is counted exactly once. The Trainer's
optimizer then runs on every rank on the same gradient, so the
parameters stay equal.

Randomness: momenta and MH uniforms are drawn at the global shape from
the caller's generator and sliced, so a sharded run draws what the
single-device Trainer draws.

Batch norm, dropout and the flowed charge loss are refused (as in the
JAX package): BN and dropout would change the arithmetic that the
sharded == single-device parity pins down, and the flowed loss would
need the sharded flow inside the gradient.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from l2hmc_torch.configs import ExperimentConfig
from l2hmc_torch.models.dynamics import Dynamics
from l2hmc_torch.models.networks import ACTIVATIONS
from l2hmc_torch.ops import su3 as g
from l2hmc_torch.ops import su3_comp as comp
from l2hmc_torch.parallel.lattice_sharded import ShardedLatticeSU3
from l2hmc_torch.parallel.mesh import Mesh
from l2hmc_torch.utils import mh


def check_config(cfg: ExperimentConfig, mesh: Mesh) -> None:
    """The configurations the 2-D mesh refuses, as clean errors."""
    if cfg.dynamics.group != "SU3":
        raise ValueError(
            "2-D (data, lattice) meshes are an SU(3) feature; U(1) "
            "lattices fit one device (use a 1-D data mesh, "
            "mesh_shape=[n, 1])")
    if cfg.network.use_batch_norm:
        raise ValueError(
            "BN under the 2-D mesh is not wired (its batch statistics would "
            "need an all-reduce over 'data'); set "
            "network.use_batch_norm=false")
    if cfg.network.dropout_prob != 0:
        raise ValueError(
            "dropout under the 2-D mesh is not wired (it would need "
            "per-shard feature-aligned masks); set network.dropout_prob=0")
    if int(getattr(cfg.loss, "charge_flow_nsteps", 0) or 0) > 0:
        raise ValueError(
            "the flowed charge loss under the 2-D mesh is not wired (the "
            "in-loss flow would need the halo-exchange flow inside the "
            "gradient); set loss.charge_flow_nsteps=0 or use a 1-D data "
            "mesh")
    t = int(cfg.dynamics.latvolume[0])
    if t % mesh.n_lattice:
        raise ValueError(f"lattice t extent {t} must divide the 'lattice' "
                         f"mesh axis ({mesh.n_lattice})")
    if cfg.dynamics.nchains % mesh.n_data:
        raise ValueError(f"nchains {cfg.dynamics.nchains} must divide the "
                         f"'data' mesh axis ({mesh.n_data})")


class ShardedTrainerSU3:
    """Train, eval and HMC steps on this rank's block.

    `dynamics` is built at the GLOBAL volume, so its parameters and masks
    are interchangeable with the single-device Trainer's;
    `update(params, grads, grad_norm)` applies clipping and the optimizer
    step. Both come from the Trainer that routes here (its optimizer, lr
    schedules and gradient accumulation). Per-chain metrics cover this
    rank's chains."""

    def __init__(self, cfg: ExperimentConfig, mesh: Mesh,
                 device: torch.device, dynamics: Dynamics,
                 update: Callable):
        from l2hmc_torch.train.trainer import dtype_for
        check_config(cfg, mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device)
        self.dtype = dtype_for(cfg)
        self.rdt = g.real_dtype(self.dtype)
        self.c1 = float(getattr(cfg, "c1", 0.0))
        self.dynamics = dynamics
        self.lat = ShardedLatticeSU3(mesh, cfg.dynamics.nchains,
                                     list(cfg.dynamics.latvolume), c1=self.c1)
        self.T = self.lat.latvolume[0]
        self.t_local = self.lat.local_volume[0]
        self.t0 = mesh.lattice_index * self.t_local
        self.xyz = self.lat.volume // self.T
        self.nb_local = self.lat.nb_local
        self.act = ACTIVATIONS[cfg.network.activation_fn]
        self._update = update

    # ------------------------------------------------------------------
    # Blocks of global tensors
    # ------------------------------------------------------------------
    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return self.lat.shard(x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.lat.gather(x)

    def random_x(self, generator=None) -> torch.Tensor:
        """A fresh hot start of this rank's block (the single-device draw,
        sliced), or the ordered one with dynamics.cold_start."""
        if getattr(self.cfg.dynamics, "cold_start", False):
            shape = (self.nb_local, 4, *self.lat.local_volume, 3, 3)
            eye = torch.eye(3, dtype=self.dtype, device=self.device)
            return eye.expand(shape).clone()
        return self.lat.random_x(generator, self.dtype, self.device)

    def _draws(self, x, generator, draws: Optional[dict]) -> dict:
        """This rank's blocks of the main pass' momenta and uniforms: of
        the global `draws` when given, else drawn in the single-device
        order (v, then u)."""
        if draws is not None:
            return {"v": self.shard(draws["v"].to(self.device)),
                    "u": self.mesh.shard_chains(draws["u"].to(self.device))}
        v = self.lat.random_v(generator, self.dtype, self.device)
        return {"v": v, "u": self.lat.random_u(generator, self.rdt,
                                                self.device)}

    # ------------------------------------------------------------------
    # The tensor-parallel network (a LeapfrogLayer's weights, sliced)
    # ------------------------------------------------------------------
    def _in_cols(self, w: torch.Tensor) -> torch.Tensor:
        """(units, 8*4*T*xyz) -> this block's input columns."""
        u = w.shape[0]
        wr = w.reshape(u, 32, self.T, self.xyz)
        return wr[:, :, self.t0:self.t0 + self.t_local].reshape(u, -1)

    def _out_rows(self, w: torch.Tensor) -> torch.Tensor:
        """(4*T*xyz*9, ...) head weight or bias -> this block's rows."""
        wr = w.reshape(4, self.T, self.xyz * 9, *w.shape[1:])
        return wr[:, self.t0:self.t0 + self.t_local].reshape(
            -1, *w.shape[1:])

    def _out_coeff(self, c: torch.Tensor) -> torch.Tensor:
        """(1, 4*T*xyz*9) ScaledTanh coefficient -> this block's columns."""
        return self._out_rows(c.reshape(-1)).reshape(1, -1)

    def _vnet(self, layer, xin: torch.Tensor, fin: torch.Tensor):
        """(nb_l, F_in_local) x2 -> (s, t, q), each (nb_l, F_out_local)."""
        nw = self.cfg.net_weights.v
        zp = (xin @ self._in_cols(layer.xlayer.weight).T
              + fin @ self._in_cols(layer.vlayer.weight).T)
        z = self.lat.lattice_sum(zp, autograd=True)
        z = self.act(z + layer.xlayer.bias + layer.vlayer.bias)
        for h in layer.hidden:
            z = self.act(F.linear(z, h.weight, h.bias))

        def head(lin):
            return F.linear(z, self._out_rows(lin.weight),
                            self._out_rows(lin.bias))

        def scaled(lin):
            coeff = self._out_coeff(lin.coeff)
            return torch.exp(coeff) * torch.tanh(head(lin))

        return (nw.s * scaled(layer.scale), nw.t * head(layer.transl),
                nw.q * scaled(layer.transf))

    # ------------------------------------------------------------------
    # The kernel on this block (Dynamics._su3_lf_step's equations)
    # ------------------------------------------------------------------
    def _vec_flat(self, coords: torch.Tensor) -> torch.Tensor:
        """(8, L_local) -> (nb_l, 8*4*t_l*xyz), the vnet's feature order."""
        nb = self.nb_local
        return coords.reshape(8, -1, nb).permute(2, 0, 1).reshape(nb, -1)

    def _stq_to_comp(self, a: torch.Tensor) -> torch.Tensor:
        nb = a.shape[0]
        return a.reshape(nb, -1, 3, 3).permute(2, 3, 1, 0).reshape(3, 3, -1)

    def _local_mask(self, m: torch.Tensor) -> torch.Tensor:
        """Per-link mask (4*V,) -> this block's (4*V_l*nb_l,) in the
        engine's (link, nb) order."""
        m = m.reshape(4, self.T, self.xyz)[:, self.t0:self.t0 + self.t_local]
        m = m.reshape(-1)
        return m[:, None].expand(m.shape[0], self.nb_local).reshape(-1)

    def _update_v(self, layer, x, v, force, eps, direction: int):
        xin = self._vec_flat(comp.su3_to_vec(x))
        fin = self._vec_flat(comp.su3_to_vec(force))
        s, t, q = self._vnet(layer, xin, fin)
        jac = 0.5 * eps * s
        logjac = jac if direction > 0 else -jac
        logdet = self.lat.lattice_sum(torch.sum(logjac, dim=1),
                                      autograd=True)
        exp_s = self._stq_to_comp(torch.exp(logjac))
        exp_q = self._stq_to_comp(torch.exp(eps * q))
        t_ = self._stq_to_comp(t)
        fn_re = force.re * exp_q + t_
        fn_im = force.im * exp_q
        half = 0.5 * eps
        w = -half if direction > 0 else half * exp_s
        return comp.F3(exp_s * v.re + w * fn_re,
                       exp_s * v.im + w * fn_im), logdet

    @staticmethod
    def _update_x(x, v, m, eps, direction: int, drift=None):
        mb = 1.0 - m
        if drift is None:
            sign = eps if direction > 0 else -eps
            drift = comp.expm(comp.scale(v, sign), order=8, s=2)
        upd = comp.mm(drift, comp.F3(mb * x.re, mb * x.im))
        xf = comp.F3(m * x.re + upd.re, m * x.im + upd.im)
        return comp.reunit(xf), drift

    def _force_traces(self, x, beta):
        """(force, this block's per-chain potential part): the plaquette
        Re-trace sum (c1 = 0, beta applied in _h), or the action itself
        (c1 != 0, autograd force through the halo rolls)."""
        lat, nb, roll = self.lat.local_volume, self.nb_local, self.lat.roll
        if self.c1 != 0.0:
            f = comp.grad_action(x, beta, lat, nb, roll=roll, c1=self.c1)
            return f, comp.action(x, beta, lat, nb, roll=roll, c1=self.c1)
        return comp.force_and_traces(x, beta, lat, nb, roll=roll)

    def _h(self, v, beta, part):
        """The Hamiltonian of this rank's chains over the whole lattice."""
        ke = comp.kinetic_energy(v, self.nb_local)
        pot = part if self.c1 != 0.0 else (-beta / 3.0) * part
        return self.lat.lattice_sum(ke + pot, autograd=True)

    def _kernel_fb(self, x_c: torch.Tensor, v_c: torch.Tensor, beta):
        """Merged fwd + bwd trajectory on this block (Dynamics._su3_scan's
        schedule). Returns (x', v', sumlogdet, H0, H1, series)."""
        dyn = self.dynamics
        x = comp.from_complex_lattice(x_c)
        v0 = comp.from_complex_lattice(v_c)
        v = v0
        sld = torch.zeros(self.nb_local, dtype=self.rdt, device=self.device)
        force, part0 = self._force_traces(x, beta)
        part = part0
        series = []
        for k, direction, flip in dyn._schedule(None):
            if flip:
                v = comp.scale(v, -1.0)
            eps_x = torch.sigmoid(dyn.xeps[k])
            eps_v = torch.sigmoid(dyn.veps[k])
            m = self._local_mask(dyn.masks[k])
            m1 = m if direction > 0 else 1.0 - m
            layer = dyn._nets(k)[0]
            v1, ld = self._update_v(layer, x, v, force, eps_v, direction)
            sld = sld + ld
            x1, drift = self._update_x(x, v1, m1, eps_x, direction)
            x, _ = self._update_x(x1, v1, 1.0 - m1, eps_x, direction,
                                  drift=drift)
            force, part = self._force_traces(x, beta)
            v, ld = self._update_v(layer, x, v1, force, eps_v, direction)
            sld = sld + ld
            if self.cfg.dynamics.verbose:
                with torch.no_grad():
                    series.append((self._h(v, beta, part), sld.detach()))
        h0 = self._h(v0, beta, part0)
        h1 = self._h(v, beta, part)
        lat, nb = self.lat.local_volume, self.nb_local
        return (comp.to_complex_lattice(x, lat, nb, self.dtype),
                comp.to_complex_lattice(v, lat, nb, self.dtype), sld, h0, h1,
                series)

    # ------------------------------------------------------------------
    # Observables and the loss, reduced over the lattice group
    # ------------------------------------------------------------------
    def _observables(self, x_c: torch.Tensor, autograd: bool = False):
        """(per-plane plaquette Re-trace sums (6, nb_l), sinQ, intQ)."""
        nb = self.nb_local
        re_pp, im_pp = comp.plaq_traces(
            comp.from_complex_lattice(x_c), self.lat.local_volume, nb,
            roll=self.lat.roll, per_plane=True)
        local = torch.stack([r.reshape(-1, nb).sum(0) for r in re_pp]
                            + [sum(i.reshape(-1, nb).sum(0) for i in im_pp)])
        tot = self.lat.lattice_sum(local, autograd=autograd)
        qs = tot[6]
        vol = self.lat.volume
        return tot[:6], qs / (6 * 3 * vol), qs / (32 * math.pi ** 2)

    def _loss(self, x1, x2, acc):
        """models/loss.LatticeLoss.calc_loss for this rank's chains: the
        site sums reduced over the lattice group, the mean over this
        rank's chains (its mean over the data group is the global loss)."""
        lc = self.cfg.loss
        p1, qs1, _ = self._observables(x1)
        p2, qs2, _ = self._observables(x2, autograd=True)
        total = torch.zeros((), dtype=self.rdt, device=self.device)

        def term(v, weight):
            v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
            if lc.use_mixed_loss:
                v = weight / (v + 1e-4) - (v + 1e-4) / weight
            else:
                v = -v / weight
            return torch.mean(v)

        if lc.plaq_weight > 0:
            total = total + term(acc * (p2 - p1) ** 2, lc.plaq_weight)
        if lc.charge_weight > 0:
            total = total + term(acc * (qs2 - qs1) ** 2, lc.charge_weight)
        if lc.rmse_weight > 0:
            dx = x2 - x1
            dx2 = (dx.real ** 2 + dx.imag ** 2).reshape(dx.shape[0], -1)
            d = self.lat.lattice_sum(dx2.sum(1), autograd=True) / (
                self.lat.volume * 4 * 9)
            total = total + term(acc * d, lc.rmse_weight)
        return total

    def _check_su(self, x: torch.Tensor):
        """ops/su3.checkSU over the whole lattice for this rank's chains."""
        d = g.norm2(g.adjoint(x) @ x - g.eye_of(x))
        d = d + torch.square(torch.abs(g.det3x3(x) - 1.0))
        d = d.reshape(d.shape[0], -1)
        tot = self.lat.lattice_sum(d.sum(-1))
        mx = self.mesh.all_reduce(d.amax(-1), "lattice", op="max")
        c = 2.0 * (3 * 3 + 1.0)
        return (torch.sqrt(tot / (4 * self.lat.volume) / c),
                torch.sqrt(mx / c))

    def _metrics(self, x_init, x_out, acc, acc_mask, sld, series) -> dict:
        p1, qs1, qi1 = self._observables(x_init)
        _, qs2, qi2 = self._observables(x_out)
        out = {"acc": acc, "acc_mask": acc_mask, "sumlogdet": acc_mask * sld,
               "plaqs": p1.sum(0) / (6 * 3 * self.lat.volume), "sinQ": qs1,
               "intQ": qi1, "dQint": torch.abs(qi2 - qi1),
               "dQsin": torch.abs(qs2 - qs1)}
        if series:
            h = torch.stack([e for e, _ in series])
            ld = torch.stack([s for _, s in series])
            out.update({"energy": h, "logdet": ld, "logprob": h - ld})
        return out

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def _transition(self, x, beta, v, u):
        xp, _, sld, h0, h1, series = self._kernel_fb(x, v, beta)
        acc = mh.accept_prob(h0 - h1 + sld)
        acc_mask = (acc > u).to(self.rdt)
        return xp, acc, acc_mask, sld, series

    def train_step(self, x, beta: float, generator=None,
                   draws: Optional[dict] = None):
        """One training step of this rank's block; `draws` may hold the
        main pass' GLOBAL momenta and uniforms {"v", "u"}. Returns
        (x_out block, metrics)."""
        dyn = self.dynamics
        aux_w = self.cfg.loss.aux_weight
        params = list(dyn.parameters())
        for p in params:
            p.grad = None
        d = self._draws(x, generator, draws)
        xp, acc, acc_mask, sld, series = self._transition(x, beta, d["v"],
                                                          d["u"])
        loss = self._loss(x, xp, acc)
        if aux_w > 0:
            # second pass from a fresh draw, in the single-device order:
            # y, then its momenta and uniforms
            y = self.random_x(generator)
            da = self._draws(y, generator, None)
            yp, acc_a, _, _, _ = self._transition(y, beta, da["v"], da["u"])
            loss = loss + aux_w * self._loss(y, yp, acc_a)
        (loss / self.mesh.n_lattice).backward()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            flat = torch.cat([gr.reshape(-1) for gr in grads])
            self.mesh.all_reduce(flat, "world")
            flat /= self.mesh.n_data
            grads = [c.view_as(gr) for c, gr in
                     zip(torch.split(flat, [gr.numel() for gr in grads]),
                         grads)]
            if self.cfg.dynamics.eps_fixed:
                grads[0].zero_()
                grads[1].zero_()
            grad_nonfinite = torch.sum(~torch.isfinite(flat))
            torch.nan_to_num_(flat)
            grad_norm = torch.sqrt(torch.sum(flat * flat))
            self._update(params, grads, grad_norm)
            loss_g = self.mesh.all_reduce(loss.detach().clone(), "data") \
                / self.mesh.n_data
            x_out = mh.select(acc_mask, xp.detach(), x)
            out = self._metrics(x, x_out, acc.detach(), acc_mask,
                                sld.detach(), series)
            out.update({"loss": loss_g, "beta": beta,
                        "xeps": torch.sigmoid(dyn.xeps.detach()),
                        "veps": torch.sigmoid(dyn.veps.detach()),
                        "grad_norm": grad_norm,
                        "grad_nonfinite": grad_nonfinite})
            out["checkSU_mean"], out["checkSU_max"] = self._check_su(x_out)
        return x_out, out

    @torch.no_grad()
    def eval_step(self, x, beta: float, generator=None,
                  draws: Optional[dict] = None):
        d = self._draws(x, generator, draws)
        xp, acc, acc_mask, sld, series = self._transition(x, beta, d["v"],
                                                          d["u"])
        x_out = mh.select(acc_mask, xp, x)
        return x_out, self._metrics(x, x_out, acc, acc_mask, sld, series)

    @torch.no_grad()
    def hmc_step(self, x, beta: float, eps: float, nleapfrog: int,
                 generator=None, draws: Optional[dict] = None):
        """Network-free HMC step on the mesh, with the single-device
        Trainer's metric keys (its plaquettes from the engine's traces)."""
        d = self._draws(x, generator, draws) if draws is not None else {}
        x_out, m = self.lat.hmc_step(x, beta, generator, eps, nleapfrog,
                                     v=d.get("v"), u=d.get("u"))
        _, qs1, qi1 = self._observables(x)
        _, qs2, qi2 = self._observables(x_out)
        return x_out, {"acc": m["acc"], "acc_mask": m["acc_mask"],
                       "plaqs": m["plaqs"], "sinQ": qs1, "intQ": qi1,
                       "dQint": torch.abs(qi2 - qi1),
                       "dQsin": torch.abs(qs2 - qs1)}

    @torch.no_grad()
    def flow_metrics(self, x, eps: float, nsteps: int) -> dict:
        _, obs = self.lat.flow(x, eps, nsteps)
        return {"flowQ": obs["Qclover"], "flow_plaq": obs["plaq"][-1],
                "flow_t2E": obs["t2E"][-1]}
