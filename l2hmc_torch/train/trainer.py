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
draws add the Wilson-flowed observables when `flow_nsteps > 0`, and the
warmup stops on plaquette stationarity. Lattice-sharded training (a
`mesh_shape` override) waits for the port of `parallel/`.

Timing: each timed region starts and ends with `torch.cuda.synchronize()`
on the card, so a step time is device time, not enqueue time.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from l2hmc_torch.configs import ExperimentConfig
from l2hmc_torch.models.dynamics import Dynamics
from l2hmc_torch.models.loss import LatticeLoss
from l2hmc_torch.ops import lattice_u1
from l2hmc_torch.ops import su3 as su3g
from l2hmc_torch.ops import su3_comp as comp
from l2hmc_torch.ops import wilson_flow as wf
from l2hmc_torch.train.annealing import Annealer, ReduceLROnPlateau
from l2hmc_torch.utils.history import History, summarize_dict
from l2hmc_torch.utils.step_timer import StepTimer

log = logging.getLogger(__name__)

BN_MOMENTUM = 0.1


def dtype_for(cfg: ExperimentConfig) -> torch.dtype:
    if cfg.dynamics.group == "SU3":
        return (torch.complex128 if cfg.precision == "float64"
                else torch.complex64)
    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.float32, "float16": torch.float32}[
                cfg.precision]


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU; no silent fallback."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "l2hmc_torch runs on a CUDA device by default, and CUDA is not "
            "available here; pass device=cpu to run on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device=None):
        if cfg.mesh_shape is not None:
            raise NotImplementedError(
                f"mesh_shape={list(cfg.mesh_shape)}: chain- and "
                "lattice-sharded training (the JAX package's parallel/) is "
                "not ported to l2hmc_torch yet (ROADMAP.md, Queue 1, items "
                "18-19); the port runs on one device")
        self.cfg = cfg
        self.device = resolve_device(device)
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

        lr = cfg.learning_rate
        self.optimizer = torch.optim.Adam(self.dynamics.parameters(),
                                          lr=lr.lr_init, eps=1e-8)
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

    # ------------------------------------------------------------------
    # Learning rate
    # ------------------------------------------------------------------
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
        return self.optimizer.param_groups[0]["lr"]

    def set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def _transition(self):
        dyn = self.dynamics
        return (dyn.apply_transition_fb if self.cfg.dynamics.merge_directions
                else dyn.apply_transition)

    def train_step(self, x, beta: float, generator=None,
                   draws: Optional[dict] = None):
        """One training step from x. `draws` may inject the main pass's
        random draws: {"v", "u", "dropout_masks"}. Returns (x_out,
        metrics)."""
        dyn = self.dynamics
        aux_w = self.cfg.loss.aux_weight
        transition = self._transition()
        params = list(dyn.parameters())
        self.optimizer.zero_grad(set_to_none=False)
        xout, metrics = transition(x, beta, generator, training=True,
                                   **(draws or {}))
        mc = metrics["mc_states"]
        loss = self.loss_fn.calc_loss(mc.init.x, mc.proposed.x,
                                      metrics["acc"])
        if aux_w > 0:
            # second pass from a fresh draw (trainer.py:1342-1353)
            y = dyn.random_x(generator, x.shape[0])
            _, maux = transition(y, beta, generator, training=True)
            mca = maux["mc_states"]
            loss = loss + aux_w * self.loss_fn.calc_loss(
                mca.init.x, mca.proposed.x, maux["acc"])
        loss.backward()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
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
            self._optimizer_update(params, grads, grad_norm)
            bn_stats = metrics.pop("bn_stats", None)
            if bn_stats:
                self._apply_bn_ema(bn_stats)
        self.step += 1
        out = {
            "loss": loss.detach(),
            "acc": metrics["acc"].detach(),
            "acc_mask": metrics["acc_mask"],
            "sumlogdet": metrics["sumlogdet"].detach(),
            "beta": beta,
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
        xout = xout.detach()
        with torch.no_grad():
            out.update(self.loss_fn.lattice_metrics(mc.init.x, xout))
            if self.cfg.dynamics.group == "SU3":
                # unitarity drift monitor in the hot loop (the reference
                # checks only in its standalone train4dSU3 script,
                # train4dSU3.py:157,191)
                out["checkSU_mean"], out["checkSU_max"] = su3g.checkSU(xout)
        return xout, out

    def _optimizer_update(self, params, grads, grad_norm):
        """Clip, accumulate, set the lr and apply Adam."""
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
            if (self.step + 1) % k != 0:
                return
            for p, a in zip(params, self._acc_grads):
                p.grad = a / k
            self._acc_grads = None
        else:
            for p, g in zip(params, grads):
                p.grad = g
        self.set_lr(self._scheduled_lr())
        self.optimizer.step()
        self.updates += 1

    def accumulated_grads(self) -> Optional[list]:
        """The open accumulation window's partial gradient sums (None
        between windows), for the checkpoint."""
        if self._acc_grads is None:
            return None
        return [g.detach().cpu() for g in self._acc_grads]

    def restore_accumulated_grads(self, grads: Optional[list]) -> None:
        self._acc_grads = (None if grads is None else
                           [g.to(self.device) for g in grads])

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
        xout, metrics = self._transition()(x, beta, generator,
                                           training=False, **(draws or {}))
        mc = metrics["mc_states"]
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
        nlf = self.evals_per_step
        xout, metrics = self.dynamics.apply_transition_hmc(
            x, beta, generator, eps=eps, nleapfrog=nlf, **(draws or {}))
        mc = metrics["mc_states"]
        out = {"acc": metrics["acc"], "acc_mask": metrics["acc_mask"]}
        out.update(self.loss_fn.lattice_metrics(mc.init.x, xout))
        if "plaqs" in metrics:
            # SU(3): the engine's free action traces replace the
            # observable path's plaquette (the same number)
            out["plaqs"] = metrics["plaqs"]
        return xout, out

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
        lat = tuple(self.cfg.dynamics.latvolume)
        nb = x.shape[0]
        res = wf.flow(comp.from_complex_lattice(x), float(self.cfg.flow_eps),
                      ns, lat, nb)
        obs = wf.flow_observables(res.t, res.tr, self.lattice.volume)
        # plaq/t2E are measured at step STARTS; [-1] is the deepest
        # measured time (ns-1)*eps
        return {"flowQ": comp.topo_charge_clover(res.x, lat, nb),
                "flow_plaq": obs["plaq"][-1], "flow_t2E": obs["t2E"][-1]}

    # ------------------------------------------------------------------
    # Warmup (trainer.py:1699-1744)
    # ------------------------------------------------------------------
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
            x, metrics = self.hmc_step(x, beta, eps, generator)
            if (step + 1) % 10 == 0:
                a = float(torch.mean(metrics["acc"]))
                if a > 0.75:
                    eps = min(eps * 1.2, 0.5)
                elif a < 0.5:
                    eps = max(eps / 1.5, 1e-5)
            if exact:
                continue
            p = float(torch.mean(metrics["plaqs"]))
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
                x, metrics = self.train_step(x, beta, generator)
                if (epoch % nlog == 0) or (epoch == epochs - 1):
                    avgs = history.update(metrics)
                    if self.trackers is not None:
                        self.trackers.update_summaries(metrics, self.step,
                                                       "train")
                        if epoch % nprint == 0:
                            # param + grad histograms on the (sparser)
                            # console cadence
                            self.trackers.log_params(self.dynamics,
                                                     self.step)
                    if "loss" in avgs:
                        era_losses.append(avgs["loss"])
                    if epoch % nprint == 0:
                        log.info(
                            f"era={era} epoch={epoch} "
                            + summarize_dict(
                                {k: avgs[k] for k in
                                 ("loss", "acc", "dQint", "dQsin", "plaqs",
                                  "grad_norm", "grad_nonfinite")
                                 if k in avgs}))
                    # stuck-chain redraw (trainer.py:1594-1600)
                    if avgs.get("acc", 1.0) < 1e-5:
                        stuck_counter += 1
                        if stuck_counter >= patience:
                            log.warning("chains stuck; redrawing x")
                            x = self.dynamics.random_x(generator)
                            stuck_counter = 0
                    else:
                        stuck_counter = 0
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
        nchains = nchains or self.cfg.nchains or max(
            2, self.cfg.dynamics.nchains // 4)
        if x is None:
            x = self.dynamics.random_x(generator, nchains)
        else:
            x = x[:nchains]
        eps = eps if eps is not None else self.cfg.dynamics.eps_hmc
        x = self.warmup(x, beta, generator, nsteps=20)
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
            if job_type == "eval":
                x, metrics = self.eval_step(x, beta, generator)
            else:
                x, metrics = self.hmc_step(x, beta, eps, generator)
            if self._flow_enabled:
                metrics = {**metrics, **self._flow_metrics(x)}
            buffered.append(metrics)
            if (step + 1) % check_interval == 0 or step == steps - 1:
                if self.trackers is not None:
                    self.trackers.update_summaries(metrics, step, job_type)
                if float(torch.mean(metrics["acc"])) < 1e-5:
                    stuck_counter += 1
                    if stuck_counter >= patience:
                        x = self.dynamics.random_x(generator, nchains)
                        stuck_counter = 0
                else:
                    stuck_counter = 0
                # dynamic HMC step size toward 66% acceptance
                if job_type == "hmc" and dynamic_step_size:
                    if float(torch.mean(metrics["acc_mask"])) < 0.66:
                        eps -= eps / 10.0
                    else:
                        eps += eps / 10.0
                    eps = float(np.clip(eps, 1e-5, 1.0))
        for metrics in buffered:
            history.update(metrics)
        _sync(self.device)
        elapsed = time.perf_counter() - t_loop
        timer.data.extend([elapsed / max(steps, 1)] * steps)
        return x, {"eps": eps}
