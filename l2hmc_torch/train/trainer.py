"""Trainer on one device: train step, eval and HMC steps, and host loops.

PyTorch counterpart of the JAX package's `train/trainer.py` (after the
reference's src/l2hmc/trainers/pytorch/trainer.py). A train step runs the
merged trajectory, the loss, its gradient through every force evaluation
(the backward force kernel on the card) and an Adam update; eval and HMC
steps run under `torch.no_grad()`. The era/epoch loops schedule beta, log
metrics, and do the host-side interventions of the reference (stuck-chain
redraw :1594-1600, dynamic HMC step size :1216-1224, warmup :1699-1744).

Optimizer: `torch.optim.Adam` (the same update as optax.adam: eps added
to sqrt of the bias-corrected second moment), with the JAX chain's
extras done here — global-norm clipping as `optax.clip_by_global_norm`,
the linear-warmup and Noam schedules and the host-side ReduceLROnPlateau
all written into the param group's lr, gradient accumulation as
`optax.MultiSteps` (mean of k micro-step gradients, one Adam update).

SU(3): the lattice is complex (complex128 at precision=float64, else
complex64), every train step reports the unitarity monitors `checkSU_*`
of its output, HMC steps report the engine's free plaquettes, eval and HMC
draws add the Wilson-flowed observables when `flow_nsteps > 0` (on the
card replayed from a CUDA graph of the whole flow, captured at the first
draw), and the warmup stops on plaquette stationarity.

Parallelism (`parallel/`, over `torch.distributed`, one process per
device). With a 1-D data mesh the chains split over the ranks: each rank
runs the step on its own chains, batch-norm statistics are those of the
global batch (an all-reduce of the sums), and the gradients are averaged
over the ranks in one flat all-reduce before counting, clipping and Adam,
so every rank applies the same update. With a 2-D (data, lattice) mesh
the steps come from `parallel/sharded_train.ShardedTrainerSU3` (SU(3)
only). Either way every random draw is made at the global shape and
sliced (`random_x`, `shard`), and every per-chain metric is gathered over
the data axis before anything reads it, so the logged means, the warmup's
eps, the plateau lr, the dynamic HMC eps and the stuck-chain redraw are
decided on global means, alike on every rank.

Compiled steps: on one CUDA device every train, eval and HMC step is
replayed from a CUDA graph, the counterpart of the JAX package's jitted
`_jit_train_step` / `_jit_eval_step` / `_jit_hmc_step` (`_run`). The
step's random draws are made before it from the caller's generator, in
the order the eager step makes them inline (`_step_draws`); beta, the HMC
eps and the draws are copied into the graph's static inputs, and the lr
is a device scalar of the optimizer (`train/optim.py`), so one graph
serves every value. `Trainer(..., graphs=False)` runs the steps eagerly
(the counterpart of `jax.disable_jit()`); the CPU and a mesh always do.

Timing: each timed region starts and ends with `torch.cuda.synchronize()`
on the card, so a step time is device time, not enqueue time.
"""
from __future__ import annotations

import copy
import logging
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from l2hmc_torch.configs import ExperimentConfig
from l2hmc_torch.models.dynamics import Dynamics
from l2hmc_torch.models.loss import LatticeLoss
from l2hmc_torch.ops import lattice_u1
from l2hmc_torch.ops import su3 as su3g
from l2hmc_torch.ops import su3_comp as comp
from l2hmc_torch.ops import wilson_flow as wf
from l2hmc_torch.ops.kernels import launches as kernel_launches
from l2hmc_torch.parallel import mesh as pmesh
from l2hmc_torch.train.annealing import Annealer, ReduceLROnPlateau
from l2hmc_torch.train.optim import Adam
from l2hmc_torch.utils import spans
from l2hmc_torch.utils.history import History, summarize_dict
from l2hmc_torch.utils.step_timer import StepTimer

log = logging.getLogger(__name__)

# the step path's spans (utils/spans.py; PERF.md §3): host spans of the
# loops and of `_run`, and the layers of the step bodies, which a graph's
# capture attributes its device operations to
STEP = spans.span(spans.STEP)
DRAWS = spans.span("trainer.draws")
RUN = spans.span("trainer.run")
RUN_INPUTS = spans.span("trainer.run.inputs")
RUN_REPLAY = spans.span("trainer.run.replay")
RUN_OUTPUTS = spans.span("trainer.run.outputs")
FLOW_HOST = spans.span("trainer.flow")
LOOP = spans.span("trainer.loop")
TRANSITION = spans.span("transition")
LOSS = spans.span("loss")
BACKWARD = spans.span("backward")
OPTIMIZER = spans.span("optimizer")
METRICS = spans.span("metrics")
FLOW = spans.span("flow")

BN_MOMENTUM = 0.1

#: per-chain metrics, (nb,) — gathered over the data axis of a mesh
CHAIN_KEYS = frozenset({
    "acc", "acc_mask", "sumlogdet", "plaqs", "p4x4", "intQ", "sinQ", "dQint",
    "dQsin", "checkSU_mean", "checkSU_max", "flowQ", "flow_plaq",
    "flow_t2E"})
#: per-leapfrog verbose series, (steps, nb)
SERIES_KEYS = frozenset({"energy", "logdet", "logprob"})


def dtype_for(cfg: ExperimentConfig) -> torch.dtype:
    if cfg.dynamics.group == "SU3":
        return (torch.complex128 if cfg.precision == "float64"
                else torch.complex64)
    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.float32, "float16": torch.float32}[
                cfg.precision]


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU; no silent fallback.
    A bare "cuda" in a process group is this process' own card,
    cuda:LOCAL_RANK."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "l2hmc_torch runs on a CUDA device by default, and CUDA is not "
            "available here; pass device=cpu to run on the CPU")
    if pmesh.world_size() > 1:
        dev = pmesh.local_device(dev)
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        spans.count("host_reads")


def _read_mean(t: torch.Tensor) -> float:
    """The mean of t on the host: a blocking read, counted."""
    spans.count("host_reads")
    return float(torch.mean(t))


class _StepGraph(NamedTuple):
    """One captured step: the graph, its static inputs and outputs, the
    force-kernel launches it holds, and its capture's numbers."""
    graph: "torch.cuda.CUDAGraph"
    inputs: dict
    outputs: tuple
    launches: dict
    stats: dict


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device=None,
                 mesh: Optional[pmesh.Mesh] = None, graphs: bool = True):
        """`mesh`: None for one device; a (n, 1) mesh splits the chains
        over n ranks; a (d, l > 1) mesh also splits the SU(3) lattice.
        `graphs`: on one CUDA device, replay every train, eval and HMC
        step from a CUDA graph (the default; the counterpart of the JAX
        package's jitted steps); False runs them eagerly, the counterpart
        of `jax.disable_jit()`. The CPU and a mesh run eagerly."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.dtype = dtype_for(cfg)
        net_cd = torch.bfloat16 if cfg.precision == "bfloat16" else None
        gen = torch.Generator().manual_seed(int(cfg.seed))
        self.dynamics = Dynamics(
            cfg.dynamics, cfg.network, cfg.net_weights, cfg.conv,
            dtype=self.dtype, net_compute_dtype=net_cd, generator=gen,
            c1=getattr(cfg, "c1", 0.0),
        ).to(self.device)
        self.lattice = self.dynamics.lattice
        self.loss_fn = LatticeLoss(self.lattice, cfg.loss)
        self.sharded = None

        lr = cfg.learning_rate
        self.optimizer = Adam(self.dynamics.parameters(), lr=lr.lr_init,
                              eps=1e-8)
        self._plateau = None
        if lr.schedule != "noam" and not (lr.warmup and lr.warmup > 0) \
                and lr.factor and lr.factor < 1.0:
            self._plateau = ReduceLROnPlateau(lr)
        self.grad_accum_steps = int(getattr(cfg, "grad_accum_steps", 1) or 1)
        #: train steps taken, and Adam updates applied (they differ under
        #: gradient accumulation; the lr schedules count updates)
        self.step = 0
        self.updates = 0
        self._acc_grads: Optional[list] = None

        sched = cfg.annealing_schedule
        sched.setup(cfg.steps.nera, cfg.steps.nepoch)
        self.schedule = sched
        self._annealer = (Annealer(sched, patience=lr.patience)
                          if sched.dynamic else None)

        self.evals_per_step = cfg.dynamics.nleapfrog * (
            2 if cfg.dynamics.merge_directions else 1)
        self.timers = {j: StepTimer(self.evals_per_step)
                       for j in ("train", "eval", "hmc", "warmup")}
        self.histories = {j: History() for j in ("train", "eval", "hmc")}
        self.trackers = None   # optional utils.trackers.Trackers fan-out
        #: the flowed observables' CUDA graphs, by input shape
        self._flow_graphs: dict = {}
        #: the steps' CUDA graphs by key (`_run`), the keys whose first,
        #: eager step has run, and the graphs' one memory pool
        self.use_graphs = (bool(graphs) and self.device.type == "cuda"
                           and mesh is None)
        self._graphs: dict = {}
        self._warm: set = set()
        self._pool = None

        if mesh is not None:
            # every rank starts from rank 0's weights and masks
            pmesh.replicate(self.dynamics, mesh)
            if mesh.n_lattice > 1:
                from l2hmc_torch.parallel.sharded_train import (
                    ShardedTrainerSU3)
                self.sharded = ShardedTrainerSU3(
                    cfg, mesh, self.device, dynamics=self.dynamics,
                    update=self._optimizer_update)
            else:
                if cfg.dynamics.nchains % mesh.n_data:
                    raise ValueError(
                        f"nchains {cfg.dynamics.nchains} must divide the "
                        f"'data' mesh axis ({mesh.n_data})")
                if mesh.n_data > 1:
                    # (with one rank on the data axis the local mean is
                    # the global one: torch.mean, as without a mesh)
                    self.dynamics.batch_mean = self._global_batch_mean

    # ------------------------------------------------------------------
    # Blocks of global tensors (the identity on one device)
    # ------------------------------------------------------------------
    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global lattice tensor."""
        if self.sharded is not None:
            return self.sharded.shard(x)
        if self.mesh is not None:
            return self.mesh.shard_chains(x)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global lattice tensor from every rank's block."""
        if self.sharded is not None:
            return self.sharded.gather(x)
        if self.mesh is not None:
            return self.mesh.gather(x, "data", 0)
        return x

    def random_x(self, generator=None, nchains: Optional[int] = None):
        """A fresh start of this rank's block, drawn at the global shape."""
        if self.sharded is not None:
            return self.sharded.random_x(generator)
        return self.shard(self.dynamics.random_x(generator, nchains))

    def _global_batch_mean(self, z: torch.Tensor) -> torch.Tensor:
        """Batch-norm mean over every rank's chains, differentiable."""
        tot = self.mesh.all_reduce(z.sum(dim=0, keepdim=True), "data",
                                   autograd=True)
        return tot / (z.shape[0] * self.mesh.n_data)

    def _dp_draws(self, x, generator, draws: Optional[dict],
                  training: bool) -> Optional[dict]:
        """A data-parallel step's draws, this rank's chains of the global
        ones: of `draws` when given, else drawn at the global shape in the
        order the single-device step draws them (v, dropout masks, u)."""
        if self.mesh is None:
            return draws
        dyn = self.dynamics
        if draws is None:
            n = x.shape[0] * self.mesh.n_data
            vx = x.new_empty((n, *x.shape[1:]))
            draws = {"v": dyn.random_v(vx, generator)}
            if dyn._dropout_on(training):
                draws["dropout_masks"] = dyn.random_dropout_masks(n,
                                                                  generator)
            draws["u"] = torch.rand((n,), generator=generator,
                                    dtype=dyn.real_dtype, device=x.device)
        out = {}
        for k, t in draws.items():
            t = t.to(x.device)
            out[k] = self.mesh.block(t, "data", 1 if k == "dropout_masks"
                                     else 0)
        return out

    def _gather_metrics(self, out: dict) -> dict:
        """Per-chain metrics of every rank's chains, on every rank."""
        if self.mesh is None:
            return out
        for k, t in out.items():
            if k in CHAIN_KEYS:
                out[k] = self.mesh.gather(t, "data", 0)
            elif k in SERIES_KEYS:
                out[k] = self.mesh.gather(t, "data", 1)
        return out

    def _allreduce_grads(self, grads: list) -> None:
        """Average the gradients over the data axis, in place, in one flat
        all-reduce."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.mesh.all_reduce(flat, "data")
        flat /= self.mesh.n_data
        for g, c in zip(grads, torch.split(flat,
                                           [g.numel() for g in grads])):
            g.copy_(c.view_as(g))

    # ------------------------------------------------------------------
    # Learning rate
    # ------------------------------------------------------------------
    @property
    def lr(self) -> float:
        """The rate of the next Adam update, on the host."""
        return self.optimizer.lr

    def _scheduled_lr(self) -> float:
        """lr for the next Adam update, evaluated at the count of updates
        applied so far (optax evaluates its schedules the same way)."""
        lr = self.cfg.learning_rate
        count = self.updates
        if lr.schedule == "noam":
            d = float(lr.model_size or max(self.cfg.network.units))
            w = float(max(lr.warmup, 1))
            s = max(float(count), 1.0)
            return lr.lr_init * d ** -0.5 * min(s ** -0.5, s * w ** -1.5)
        if lr.warmup and lr.warmup > 0:
            return lr.lr_init * min(count, lr.warmup) / lr.warmup
        return self.optimizer.lr

    def set_lr(self, lr: float) -> None:
        """Write the rate into the optimizer's device scalar, which the
        next update reads (eager or replayed)."""
        self.optimizer.set_lr(lr)

    def load_optimizer_state(self, state: dict) -> None:
        """Restore the optimizer (its own state dict or torch.optim.Adam's)
        and drop the captured steps, which hold the old state's tensors."""
        self.optimizer.load_state_dict(state)
        self._graphs.clear()
        self._warm.clear()

    def _scalar(self, value) -> torch.Tensor:
        """beta or eps as the step reads it: a 0-d tensor of the real
        dtype on the device (written by a fill: no synchronisation)."""
        rdt = self.dynamics.real_dtype
        if isinstance(value, torch.Tensor) and value.device == self.device:
            return value.reshape(()).to(rdt)
        return torch.full((), float(value), dtype=rdt, device=self.device)

    # ------------------------------------------------------------------
    # Random draws, made before the step
    # ------------------------------------------------------------------
    def _transition_draws(self, x, generator, training: bool,
                          given: Optional[dict] = None, hmc: bool = False,
                          prefix: str = "") -> dict:
        """The draws of one transition from x (this rank's chains), made
        in the order the transition makes them inline: the direction
        (single-direction L2HMC; a bool, part of the graph key), v, the
        dropout masks (training with dropout), the MH uniforms u. What
        `given` holds is taken (on a mesh: global, blocked here) and what
        it lacks is drawn at the global shape."""
        dyn = self.dynamics
        given = given or {}
        out = {}
        if not hmc and not self.cfg.dynamics.merge_directions:
            fwd = given.get("forward")
            if fwd is None:
                spans.count("host_reads")
                fwd = bool(torch.rand((), generator=generator,
                                      device=x.device) < 0.5)
            out["forward"] = bool(fwd)
        n = x.shape[0] * (self.mesh.n_data if self.mesh is not None else 1)
        vx = x if self.mesh is None else x.new_empty((n, *x.shape[1:]))
        out["v"] = given["v"] if "v" in given else dyn.random_v(vx,
                                                                 generator)
        if not hmc and dyn._dropout_on(training):
            out["dropout_masks"] = (
                given["dropout_masks"] if "dropout_masks" in given
                else dyn.random_dropout_masks(n, generator))
        out["u"] = given["u"] if "u" in given else torch.rand(
            (n,), generator=generator, dtype=dyn.real_dtype, device=x.device)
        for k, t in out.items():
            if isinstance(t, torch.Tensor):
                t = t.to(x.device)
                if self.mesh is not None:
                    t = self.mesh.block(t, "data",
                                        1 if k == "dropout_masks" else 0)
                out[k] = t
        return {prefix + k: t for k, t in out.items()}

    def _step_draws(self, job: str, x, generator,
                    draws: Optional[dict]) -> dict:
        """Every draw of one step, in the order the step would make them
        inline; `draws` may hold the main transition's. A train step with
        loss.aux_weight > 0 adds its second pass's fresh start `y` and
        that pass's draws (keys prefixed "aux_")."""
        out = self._transition_draws(x, generator, job == "train", draws,
                                     hmc=job == "hmc")
        if job == "train" and self.cfg.loss.aux_weight > 0:
            n = x.shape[0] * (self.mesh.n_data if self.mesh else 1)
            y = self.random_x(generator, n)
            out["aux_y"] = y
            out.update(self._transition_draws(y, generator, True,
                                              prefix="aux_"))
        return out

    @staticmethod
    def _pass_draws(d: dict, prefix: str = "") -> dict:
        """The keyword draws of one transition out of a step's draws."""
        keys = ("forward", "v", "u", "dropout_masks")
        return {k: d[prefix + k] for k in keys if prefix + k in d}

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def _transition(self):
        dyn = self.dynamics
        return (dyn.apply_transition_fb if self.cfg.dynamics.merge_directions
                else dyn.apply_transition)

    def _takes_update(self) -> bool:
        """Whether the coming train step ends an accumulation window
        (optax.MultiSteps: an Adam update every grad_accum_steps steps)."""
        k = self.grad_accum_steps
        return k <= 1 or (self.step + 1) % k == 0

    def train_step(self, x, beta: float, generator=None,
                   draws: Optional[dict] = None):
        """One training step from x. `draws` may inject the main pass's
        random draws: {"v", "u", "dropout_masks"} (on a mesh: the global
        ones); the rest are drawn from `generator` before the step.
        Returns (x_out, metrics)."""
        if self.sharded is not None:
            xout, out = self.sharded.train_step(x, beta, generator, draws)
            self.step += 1
            return xout, self._gather_metrics(out)
        with DRAWS:
            d = self._step_draws("train", x, generator, draws)
        update = self._takes_update()
        if update:
            self.set_lr(self._scheduled_lr())
        xout, out = self._run("train", self._train_body, x,
                              self._scalar(beta), d, update=update)
        if update:
            self.updates += 1
        self.step += 1
        out["beta"] = beta
        return xout, self._gather_metrics(out)

    def _train_body(self, x, beta, update: bool, generator=None, **d):
        """A train step's device work: the transition(s), the loss, its
        gradient, the update and the BN statistics. beta is a 0-d tensor;
        `d` holds the step's draws (`_step_draws`), and what it lacks the
        transitions draw inline from `generator`. This is what a CUDA
        graph of the step captures."""
        dyn = self.dynamics
        aux_w = self.cfg.loss.aux_weight
        transition = self._transition()
        params = list(dyn.parameters())
        with OPTIMIZER:
            self.optimizer.zero_grad(set_to_none=False)
        with TRANSITION:
            xout, metrics = transition(x, beta, generator, training=True,
                                       **self._pass_draws(d))
        mc = metrics["mc_states"]
        with LOSS:
            loss = self.loss_fn.calc_loss(mc.init.x, mc.proposed.x,
                                          metrics["acc"])
        if aux_w > 0:
            # second pass from a fresh draw (trainer.py:1342-1353)
            y = d.get("aux_y")
            if y is None:
                y = self.random_x(generator, x.shape[0])
            with TRANSITION:
                _, maux = transition(y, beta, generator, training=True,
                                     **self._pass_draws(d, "aux_"))
            mca = maux["mc_states"]
            with LOSS:
                loss = loss + aux_w * self.loss_fn.calc_loss(
                    mca.init.x, mca.proposed.x, maux["acc"])
        with BACKWARD:
            loss.backward()
        with torch.no_grad(), OPTIMIZER:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if self.mesh is not None:
                self._allreduce_grads(grads)
            if self.cfg.dynamics.eps_fixed:
                dyn.xeps.grad.zero_()
                dyn.veps.grad.zero_()
            # count the non-finite entries BEFORE zeroing them: a silent
            # nan_to_num once ate all-NaN gradients for rounds
            grad_nonfinite = sum(torch.sum(~torch.isfinite(g))
                                 for g in grads)
            for g in grads:
                torch.nan_to_num_(g)
            grad_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            self._apply_update(params, grads, grad_norm, update)
            bn_stats = metrics.pop("bn_stats", None)
            if bn_stats:
                self._apply_bn_ema(bn_stats)
        loss = loss.detach()
        if self.mesh is not None:
            loss = self.mesh.all_reduce(loss.clone(), "data") \
                / self.mesh.n_data
        xout = xout.detach()
        with torch.no_grad(), METRICS:
            out = {
                "loss": loss,
                "acc": metrics["acc"].detach(),
                "acc_mask": metrics["acc_mask"],
                "sumlogdet": metrics["sumlogdet"].detach(),
                "xeps": torch.sigmoid(dyn.xeps.detach()),
                "veps": torch.sigmoid(dyn.veps.detach()),
                "grad_norm": grad_norm,
                "grad_nonfinite": grad_nonfinite,
            }
            if "per_step" in metrics:
                # per-leapfrog verbose series (dynamics.verbose=true):
                # (2*nlf, nb) tensors; History maps them to the
                # (chain, leapfrog, draw) dataset dims
                out.update(metrics["per_step"])
            out.update(self.loss_fn.lattice_metrics(mc.init.x, xout))
            if self.cfg.dynamics.group == "SU3":
                # unitarity drift monitor in the hot loop (the reference
                # checks only in its standalone train4dSU3 script,
                # train4dSU3.py:157,191)
                out["checkSU_mean"], out["checkSU_max"] = su3g.checkSU(xout)
        return xout, out

    def _optimizer_update(self, params, grads, grad_norm):
        """Clip, accumulate, set the lr and apply Adam, deciding on the
        host whether this step ends an accumulation window (the sharded
        trainer's update)."""
        update = self._takes_update()
        if update:
            self.set_lr(self._scheduled_lr())
        self._apply_update(params, grads, grad_norm, update)
        if update:
            self.updates += 1

    def _apply_update(self, params, grads, grad_norm, update: bool):
        """Clip, add to the accumulation window and, when `update`, apply
        Adam to the window's mean (to the gradient itself without
        accumulation). The window's sums live in buffers that persist
        across steps and are zeroed in place after each update."""
        clip = self.cfg.learning_rate.clip_norm
        if clip and clip > 0:
            # optax.clip_by_global_norm: g * clip / norm when norm >= clip
            scale = torch.where(grad_norm < clip, torch.ones_like(grad_norm),
                                clip / grad_norm)
            for g in grads:
                g.mul_(scale)
        k = self.grad_accum_steps
        if k > 1:
            if self._acc_grads is None:
                self._acc_grads = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self._acc_grads, grads):
                a.add_(g)
            if not update:
                return
            for a, g in zip(self._acc_grads, grads):
                torch.div(a, k, out=g)
                a.zero_()
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.step()

    def accumulated_grads(self) -> Optional[list]:
        """The open accumulation window's partial gradient sums (None
        between windows), for the checkpoint."""
        if self._acc_grads is None or self.step % self.grad_accum_steps == 0:
            return None
        return [g.detach().cpu() for g in self._acc_grads]

    def restore_accumulated_grads(self, grads: Optional[list]) -> None:
        """Set the window's sums (None: an empty window), in place where
        the buffers exist, so captured steps keep reading them."""
        if self._acc_grads is None:
            self._acc_grads = (None if grads is None else
                               [g.to(self.device) for g in grads])
            return
        for a, g in zip(self._acc_grads, grads or [None] * len(
                self._acc_grads)):
            if g is None:
                a.zero_()
            else:
                a.copy_(g)

    @torch.no_grad()
    def _apply_bn_ema(self, bn_stats: list) -> None:
        """Fold the batch (mean, var) of every BN call of the trajectory
        into the running statistics with momentum 0.1 (torch BatchNorm1d
        semantics, reference network.py:507; JAX trainer.py:311-361). A
        per-step net averages its samples from both directions; vnets
        count both calls of each step."""
        cfg = self.cfg.dynamics
        sep = cfg.use_separate_networks
        dyn = self.dynamics
        samples: dict = {}

        def add(name, k, pair):
            if pair is not None:
                samples.setdefault((name, k if sep else 0), []).append(pair)

        for k, bn in bn_stats:
            add("vnets", k, bn["v"][0])
            add("vnets", k, bn["v"][1])
            if "x0" not in bn:      # SU(3): no x networks
                continue
            if cfg.use_split_xnets:
                add("xnets_first", k, bn["x0"])
                add("xnets_second", k, bn["x1"])
            else:
                add("xnets_first", k, bn["x0"])
                add("xnets_first", k, bn["x1"])
        for (name, i), pairs in samples.items():
            layer_bn = getattr(dyn, name)[i].bn
            if layer_bn is None:
                continue
            m_est = torch.stack([p[0] for p in pairs]).mean(0)
            v_est = torch.stack([p[1] for p in pairs]).mean(0)
            layer_bn.r_mean.mul_(1.0 - BN_MOMENTUM).add_(
                BN_MOMENTUM * m_est.to(layer_bn.r_mean.dtype))
            layer_bn.r_var.mul_(1.0 - BN_MOMENTUM).add_(
                BN_MOMENTUM * v_est.to(layer_bn.r_var.dtype))

    @torch.no_grad()
    def eval_step(self, x, beta: float, generator=None,
                  draws: Optional[dict] = None):
        if self.sharded is not None:
            xout, out = self.sharded.eval_step(x, beta, generator, draws)
            return xout, self._gather_metrics(out)
        with DRAWS:
            d = self._step_draws("eval", x, generator, draws)
        xout, out = self._run("eval", self._eval_body, x, self._scalar(beta),
                              d)
        return xout, self._gather_metrics(out)

    def _eval_body(self, x, beta, generator=None, **d):
        with TRANSITION:
            xout, metrics = self._transition()(x, beta, generator,
                                               training=False,
                                               **self._pass_draws(d))
        mc = metrics["mc_states"]
        with METRICS:
            out = {
                "acc": metrics["acc"],
                "acc_mask": metrics["acc_mask"],
                "sumlogdet": metrics["sumlogdet"],
            }
            if "per_step" in metrics:
                out.update(metrics["per_step"])
            out.update(self.loss_fn.lattice_metrics(mc.init.x, xout))
        return xout, out

    @torch.no_grad()
    def hmc_step(self, x, beta: float, eps: float, generator=None,
                 draws: Optional[dict] = None):
        if self.sharded is not None:
            xout, out = self.sharded.hmc_step(x, beta, eps,
                                              self.evals_per_step, generator,
                                              draws)
            return xout, self._gather_metrics(out)
        with DRAWS:
            d = self._step_draws("hmc", x, generator, draws)
        d["eps"] = self._scalar(eps)
        xout, out = self._run("hmc", self._hmc_body, x, self._scalar(beta), d)
        return xout, self._gather_metrics(out)

    def _hmc_body(self, x, beta, eps, generator=None, **d):
        with TRANSITION:
            xout, metrics = self.dynamics.apply_transition_hmc(
                x, beta, generator, eps=eps, nleapfrog=self.evals_per_step,
                **self._pass_draws(d))
        mc = metrics["mc_states"]
        with METRICS:
            out = {"acc": metrics["acc"], "acc_mask": metrics["acc_mask"]}
            out.update(self.loss_fn.lattice_metrics(mc.init.x, xout))
        if "plaqs" in metrics:
            # SU(3): the engine's free action traces replace the
            # observable path's plaquette (the same number)
            out["plaqs"] = metrics["plaqs"]
        return xout, out

    # ------------------------------------------------------------------
    # Compiled steps: CUDA graphs (the counterpart of the JAX package's
    # _jit_train_step / _jit_eval_step / _jit_hmc_step)
    # ------------------------------------------------------------------
    @RUN
    def _run(self, job: str, body, x, beta, d: dict, **flags):
        """body(x, beta, **d, **flags) -> (x_out, metrics): eagerly, or on
        the card replayed from a CUDA graph. A graph is keyed as JAX keys
        its traces: the job, the shapes and dtypes of its tensor inputs,
        and what is decided on the host (the direction of a
        single-direction transition, whether a train step applies the
        Adam update, and the accumulation count it was traced with).
        beta, eps, the draws and x are copied into the graph's static
        inputs before each replay, and the lr is read from the
        optimizer's device scalar, so no value of theirs is baked in.
        A key's first step runs eagerly on a side stream (it warms the
        allocator, the libraries and the optimizer state); the second is
        captured and every later one replayed. A failed capture or replay
        raises."""
        tensors = {"x": x, "beta": beta}
        for k, v in d.items():
            if isinstance(v, torch.Tensor):
                tensors[k] = v
            else:
                flags[k] = v
        if not self.use_graphs:
            return body(**tensors, **flags)
        key = (job, tuple((k, tuple(t.shape), t.dtype)
                          for k, t in tensors.items()),
               tuple(sorted(flags.items())),
               self.grad_accum_steps if job == "train" else 1)
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._warm:
                self._warm.add(key)
                cur = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    res = body(**tensors, **flags)
                cur.wait_stream(side)
                return res
            entry = self._capture(key, body, tensors, flags)
        with RUN_INPUTS:
            for k, t in tensors.items():
                entry.inputs[k].copy_(t)
        with RUN_REPLAY:
            entry.graph.replay()
            kernel_launches.count_replay(entry.launches)
            entry.stats["replays"] += 1
        with RUN_OUTPUTS:
            xout, out = entry.outputs
            return xout.clone(), {k: v.clone() for k, v in out.items()}

    def _capture(self, key, body, tensors: dict, flags: dict):
        """Capture body into a CUDA graph over static copies of its
        inputs, in the trainer's one memory pool, and time the capture
        (the body's host run, recording) and its end (instantiation).
        The spans inside the body attribute the graph's device operations
        (`spans.capture`)."""
        static = {k: t.clone() for k, t in tensors.items()}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        _sync(self.device)
        # the capture empties the allocator's cache first: so does this,
        # so that the reserved memory grows by the pool's new segments only
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        with kernel_launches.captured() as launches:
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, pool=self._pool):
                with spans.capture(graph) as cap:
                    outputs = body(**static, **flags)
                t1 = time.perf_counter()
            t2 = time.perf_counter()
        stats = {"job": key[0], "flags": dict(key[2]),
                 "grad_accum_steps": key[3],
                 "shapes": {k: list(s) for k, s, _ in key[1]},
                 "capture_s": t1 - t0, "instantiate_s": t2 - t1,
                 "pool_bytes_added": torch.cuda.memory_reserved(self.device)
                 - reserved, "launches": dict(launches), "replays": 0,
                 **cap.stats}
        entry = _StepGraph(graph, static, outputs, dict(launches), stats)
        self._graphs[key] = entry
        return entry

    def twin(self, graphs: bool) -> "Trainer":
        """A second one-device Trainer of this config on this device with
        this one's parameters, buffers, optimizer state, step counters
        and accumulation window; `graphs` chooses how it runs its steps
        (eager against graphed comparisons and timings)."""
        other = Trainer(self.cfg, device=self.device, graphs=graphs)
        other.dynamics.load_state_dict(self.dynamics.state_dict())
        other.load_optimizer_state(copy.deepcopy(self.optimizer.state_dict()))
        other.grad_accum_steps = self.grad_accum_steps
        other.step, other.updates = self.step, self.updates
        if self._acc_grads is not None:
            other._acc_grads = [g.clone() for g in self._acc_grads]
        return other

    def graph_stats(self) -> list:
        """Per captured graph, the steps' and the flow's (job "flow"): its
        job, host-decided flags, input shapes, capture and instantiation
        seconds, its replays, its device operations (`ops`: kernel, copy
        and fill nodes), each span's inclusive operations (`span_ops`,
        "(none)": in no span) and their [first, last) operation ordinals
        (`span_ranges`), the force-kernel launches it holds; a step graph
        also the memory its capture added to the pool."""
        return [dict(e.stats) for e in (*self._graphs.values(),
                                        *self._flow_graphs.values())]

    # ------------------------------------------------------------------
    # Wilson-flowed eval observables (flow_nsteps > 0, SU(3) only):
    # flowed clover topological charge + smoothed plaquette + t^2 E per
    # draw (ops/wilson_flow.py). The reference has no flow and its SU(3)
    # integer charge is a TODO stub; the flowed clover charge is the
    # observable that shows integer tunneling.
    # ------------------------------------------------------------------
    @property
    def _flow_enabled(self) -> bool:
        return (self.cfg.dynamics.group == "SU3"
                and int(getattr(self.cfg, "flow_nsteps", 0)) > 0)

    @torch.no_grad()
    def _flow_metrics(self, x) -> dict:
        ns = int(self.cfg.flow_nsteps)
        if self.sharded is not None:
            return self._gather_metrics(self.sharded.flow_metrics(
                x, float(self.cfg.flow_eps), ns))
        if x.is_cuda:
            return self._gather_metrics(self._flow_replay(x))
        return self._gather_metrics(self._flow_observables(x))

    @FLOW
    def _flow_observables(self, x) -> dict:
        lat = tuple(self.cfg.dynamics.latvolume)
        nb = x.shape[0]
        res = wf.flow(comp.from_complex_lattice(x), float(self.cfg.flow_eps),
                      int(self.cfg.flow_nsteps), lat, nb)
        obs = wf.flow_observables(res.t, res.tr, self.lattice.volume)
        # plaq/t2E are measured at step STARTS; [-1] is the deepest
        # measured time (ns-1)*eps
        return {"flowQ": comp.topo_charge_clover(res.x, lat, nb),
                "flow_plaq": obs["plaq"][-1], "flow_t2E": obs["t2E"][-1]}

    def _flow_replay(self, x) -> dict:
        """`_flow_observables` on the card, captured once per input shape
        in a CUDA graph and replayed: the same kernels in the same order,
        without the host's launch cost (the 12-step flow of an 8^4 x 8
        draw is ~53,000 launches: 1,026 ms eager, 137 ms replayed on an
        H100). Its graph is listed by `graph_stats` under job "flow"."""
        key = (tuple(x.shape), x.dtype, x.device)
        if key not in self._flow_graphs:
            static_x = x.clone()
            side = torch.cuda.Stream(x.device)
            side.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(side):
                self._flow_observables(static_x)      # warm the allocator
            torch.cuda.current_stream(x.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with kernel_launches.captured() as launches:
                t0 = time.perf_counter()
                with torch.cuda.graph(graph):
                    with spans.capture(graph) as cap:
                        out = self._flow_observables(static_x)
                    t1 = time.perf_counter()
                t2 = time.perf_counter()
            stats = {"job": "flow", "flags": {}, "grad_accum_steps": 1,
                     "shapes": {"x": list(x.shape)}, "capture_s": t1 - t0,
                     "instantiate_s": t2 - t1, "launches": dict(launches),
                     "replays": 0, **cap.stats}
            self._flow_graphs[key] = _StepGraph(graph, {"x": static_x}, out,
                                                dict(launches), stats)
        entry = self._flow_graphs[key]
        entry.inputs["x"].copy_(x)
        entry.graph.replay()
        kernel_launches.count_replay(entry.launches)
        entry.stats["replays"] += 1
        return {k: v.clone() for k, v in entry.outputs.items()}

    # ------------------------------------------------------------------
    # Profile (JAX trainer.py:496-512)
    # ------------------------------------------------------------------
    def profile(self, x, beta: float, generator=None, nsteps: int = 5,
                outdir: str = "profile"):
        """Run nsteps unlogged train steps under torch.profiler (host
        activity, and the card's where the trainer runs on one) and write
        the Chrome trace `<outdir>/trace_step<N>.json`, N the train step
        count after them (open it in Perfetto or chrome://tracing). The
        histories are not touched; the optimizer and the step count
        advance as in training. Returns the advanced x.

        Unlike the JAX package, which takes plain steps when its backend
        cannot trace, a failure to trace raises."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        _sync(self.device)
        with torch_profile(activities=activities) as prof, \
                spans.job("profile"):
            for _ in range(nsteps):
                with STEP:
                    x, _ = self.train_step(x, beta, generator)
            _sync(self.device)
        os.makedirs(outdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(outdir,
                                              f"trace_step{self.step}.json"))
        return x

    # ------------------------------------------------------------------
    # Warmup (trainer.py:1699-1744)
    # ------------------------------------------------------------------
    @spans.job("warmup")
    def warmup(self, x, beta: float, generator=None, nsteps: int = 100,
               tol: float = 1e-5, su3_rtol: float = 2e-3,
               exact: bool = False):
        """Thermalize with HMC, capped at nsteps; exact=True runs all
        nsteps. U(1) stops when the mean plaquette reaches the exact i1/i0
        value (the reference's criterion, trainer.py:1720-1731). SU(3) has
        no closed form, so it stops on plaquette stationarity: the drift
        between two adjacent 5-step windowed means below su3_rtol
        (relative).

        The step size self-tunes every 10 trajectories (x1.2 above 0.75
        acceptance, /1.5 below 0.5): thermalization measures nothing, so
        eps is free, and a fixed eps can deadlock (from the ordered start
        dH scales with the volume, and 8^4 at the production eps rejects
        everything)."""
        eps = self.cfg.dynamics.eps_hmc
        pexact = (float(lattice_u1.plaq_exact(beta))
                  if self.cfg.dynamics.group == "U1" else None)
        window: list[float] = []
        for step in range(nsteps):
            with STEP:
                spans.count("steps")
                x, metrics = self.hmc_step(x, beta, eps, generator)
                with LOOP:
                    if (step + 1) % 10 == 0:
                        a = _read_mean(metrics["acc"])
                        if a > 0.75:
                            eps = min(eps * 1.2, 0.5)
                        elif a < 0.5:
                            eps = max(eps / 1.5, 1e-5)
                    if exact:
                        continue
                    p = _read_mean(metrics["plaqs"])
                    if pexact is not None:
                        if abs(p - pexact) < tol:
                            break
                    else:
                        window.append(p)
                        if len(window) >= 10:
                            m1 = float(np.mean(window[-5:]))
                            m0 = float(np.mean(window[-10:-5]))
                            if abs(m1 - m0) <= su3_rtol * max(1.0, abs(m1)):
                                break
        return x

    # ------------------------------------------------------------------
    # Train loop (trainer.py:1746-1838, train_epoch :1478-1637)
    # ------------------------------------------------------------------
    @spans.job("train")
    def train(self, x, generator=None, nera=None, nepoch=None,
              console_interval: Optional[int] = None, start_era: int = 0,
              max_eras: Optional[int] = None, era_callback=None,
              beta_init: Optional[float] = None):
        """Era/epoch loop. start_era/beta_init resume mid-ladder; max_eras
        bounds the eras this call runs; era_callback(era, x, beta) fires
        after each era (the Experiment's per-era checkpoint)."""
        steps = self.cfg.steps
        nera = nera if nera is not None else steps.nera
        nepoch = nepoch if nepoch is not None else steps.nepoch
        history = self.histories["train"]
        timer = self.timers["train"]
        patience = 5
        stuck_counter = 0
        nlog = steps.log
        nprint = console_interval or steps.print
        annealer = self._annealer
        beta = (beta_init if beta_init is not None
                else self.schedule.beta_for_era(start_era, nera))
        end_era = nera if max_eras is None else min(nera, start_era + max_eras)
        fixed = int(getattr(steps, "warmup", 0) or 0)

        for era in range(start_era, end_era):
            if annealer is None:
                beta = self.schedule.beta_for_era(era, nera)
            era_losses: list[float] = []
            # re-thermalize at every era's beta (trainer.py:1788)
            if fixed > 0:
                cap = fixed if era == 0 else max(1, fixed // 4)
            elif self.cfg.dynamics.group == "SU3":
                cap = 60 if era == 0 else 30
            else:
                cap = 20 if era == 0 else 10
            x = self.warmup(x, beta, generator, nsteps=cap, exact=fixed > 0)
            epochs = nepoch
            if era == nera - 1 and steps.extend_last_era:
                epochs = nepoch * int(steps.extend_last_era)
            _sync(self.device)
            t_era = time.perf_counter()
            for epoch in range(epochs):
                with STEP:
                    spans.count("steps")
                    x, metrics = self.train_step(x, beta, generator)
                    with LOOP:
                        if (epoch % nlog == 0) or (epoch == epochs - 1):
                            x, stuck_counter = self._log_train(
                                metrics, x, generator, era, epoch, nprint,
                                era_losses, stuck_counter, patience)
            _sync(self.device)
            era_elapsed = time.perf_counter() - t_era
            timer.data.extend([era_elapsed / max(epochs, 1)] * epochs)
            esumm = history.era_summary(era)
            log.info(f"era {era} done in {era_elapsed:.1f}s "
                     f"(beta={beta:.3f}) "
                     + summarize_dict({k: esumm[k] for k in ("loss", "acc")
                                       if k in esumm}))
            if annealer is not None and era_losses:
                beta = annealer.end_era(era, beta, era_losses)
            if self._plateau is not None and era_losses:
                self.set_lr(self._plateau.update(float(np.min(era_losses))))
            if era_callback is not None:
                era_callback(era, x, float(beta))
        return x

    def _log_train(self, metrics, x, generator, era, epoch, nprint,
                   era_losses, stuck_counter, patience):
        """A logged train step's host work: the history, the trackers, the
        console line, the era's losses and the stuck-chain redraw
        (trainer.py:1594-1600). Returns (x, stuck_counter)."""
        avgs = self.histories["train"].update(metrics)
        if self.trackers is not None:
            self.trackers.update_summaries(metrics, self.step, "train")
            if epoch % nprint == 0:
                # param + grad histograms on the (sparser) console cadence
                self.trackers.log_params(self.dynamics, self.step)
        if "loss" in avgs:
            era_losses.append(avgs["loss"])
        if epoch % nprint == 0:
            log.info(f"era={era} epoch={epoch} " + summarize_dict(
                {k: avgs[k] for k in ("loss", "acc", "dQint", "dQsin",
                                      "plaqs", "grad_norm",
                                      "grad_nonfinite") if k in avgs}))
        if avgs.get("acc", 1.0) < 1e-5:
            stuck_counter += 1
            if stuck_counter >= patience:
                log.warning("chains stuck; redrawing x")
                x = self.random_x(generator)
                stuck_counter = 0
        else:
            stuck_counter = 0
        return x, stuck_counter

    def _check_draws(self, metrics, x, eps, generator, job_type, step,
                     nchains, dynamic_step_size, stuck_counter, patience):
        """The draw loop's host logic every check_interval draws: the
        trackers, the stuck-chain redraw and the dynamic HMC step size
        toward 66 % acceptance. Returns (x, eps, stuck_counter)."""
        if self.trackers is not None:
            self.trackers.update_summaries(metrics, step, job_type)
        if _read_mean(metrics["acc"]) < 1e-5:
            stuck_counter += 1
            if stuck_counter >= patience:
                x = self.random_x(generator, nchains)
                stuck_counter = 0
        else:
            stuck_counter = 0
        if job_type == "hmc" and dynamic_step_size:
            if _read_mean(metrics["acc_mask"]) < 0.66:
                eps -= eps / 10.0
            else:
                eps += eps / 10.0
            eps = float(np.clip(eps, 1e-5, 1.0))
        return x, eps, stuck_counter

    def controller_state(self) -> dict:
        """Host-side controller memory (ReduceLROnPlateau + Annealer)."""
        out = {}
        if self._plateau is not None:
            out["plateau"] = self._plateau.state_dict()
        if self._annealer is not None:
            out["annealer"] = self._annealer.state_dict()
        return out

    def restore_controllers(self, state: dict) -> None:
        if self._plateau is not None and "plateau" in state:
            self._plateau.load_state_dict(state["plateau"])
        if self._annealer is not None and "annealer" in state:
            self._annealer.load_state_dict(state["annealer"])

    # ------------------------------------------------------------------
    # Eval / HMC loop (trainer.py:1085-1252)
    # ------------------------------------------------------------------
    def evaluate(self, generator=None, job_type: str = "eval",
                 nsteps: Optional[int] = None, beta: Optional[float] = None,
                 x=None, eps: Optional[float] = None,
                 nchains: Optional[int] = None,
                 dynamic_step_size: bool = True):
        if job_type not in ("eval", "hmc"):
            raise ValueError(f"job_type must be eval or hmc, got {job_type}")
        steps = nsteps if nsteps is not None else self.cfg.steps.test
        beta = beta if beta is not None else self.schedule.beta_final
        if self.sharded is not None:
            # the 2-D mesh evaluates the configured chains, as in the JAX
            # package: a subset would unbalance the 'data' axis
            nchains = self.cfg.dynamics.nchains
        else:
            nchains = nchains or self.cfg.nchains or max(
                2, self.cfg.dynamics.nchains // 4)
        if x is None:
            x = self.random_x(generator, nchains)
        elif self.sharded is None:
            # the global first nchains chains, as one device takes them
            x = self.shard(self.gather(x)[:nchains])
        eps = eps if eps is not None else self.cfg.dynamics.eps_hmc
        x = self.warmup(x, beta, generator, nsteps=20)
        with spans.job(job_type):
            history = self.histories[job_type]
            timer = self.timers[job_type]
            patience, stuck_counter = 5, 0
            # metrics stay on the device during the loop; acc is read back
            # only every check_interval steps for the host logic
            check_interval = 10
            buffered: list[dict] = []
            _sync(self.device)
            t_loop = time.perf_counter()
            for step in range(steps):
                with STEP:
                    spans.count("steps")
                    if job_type == "eval":
                        x, metrics = self.eval_step(x, beta, generator)
                    else:
                        x, metrics = self.hmc_step(x, beta, eps, generator)
                    if self._flow_enabled:
                        with FLOW_HOST:
                            metrics = {**metrics, **self._flow_metrics(x)}
                    with LOOP:
                        buffered.append(metrics)
                        if (step + 1) % check_interval == 0 \
                                or step == steps - 1:
                            x, eps, stuck_counter = self._check_draws(
                                metrics, x, eps, generator, job_type, step,
                                nchains, dynamic_step_size, stuck_counter,
                                patience)
            with LOOP:
                for metrics in buffered:
                    history.update(metrics)
            _sync(self.device)
            elapsed = time.perf_counter() - t_loop
            timer.data.extend([elapsed / max(steps, 1)] * steps)
            return x, {"eps": eps}
