"""Experiment orchestration: train -> eval -> HMC baseline -> improvement.

PyTorch counterpart of the JAX package's `experiment.py` (after the
reference's Experiment + __main__ pipeline, src/l2hmc/__main__.py:100-249):
build everything from an ExperimentConfig, train with the beta ladder,
evaluate the trained sampler, run the matched-cost HMC baseline, and report
`model_improvement = mean(dQint_eval) / mean(dQint_hmc)`.

Runs on the card unless `device="cpu"` is asked for. All random draws
come from one `torch.Generator` on that device, seeded from `cfg.seed`;
the network weights and masks come from a CPU generator of the same seed,
so they do not depend on the device.

Several processes (torchrun, or `setup_distributed` with an explicit
init_method) join one process group before any device is chosen, each on
its own device, and split the work over a mesh (`parallel/mesh.py`):
`mesh_shape=[d, l]` asks for d ranks over the chains and l over the SU(3)
lattice's t axis; without it the chains split over all the ranks. Every
rank draws the same global numbers and keeps its block, so a run on
several ranks samples what one device samples. Rank 0 alone writes the
output directory; the checkpoint holds the global x.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from l2hmc_torch.configs import ExperimentConfig, get_config
from l2hmc_torch.parallel import mesh as pmesh
from l2hmc_torch.train.trainer import Trainer
from l2hmc_torch.utils import checkpoint as ckpt

log = logging.getLogger(__name__)


def build_mesh(cfg: ExperimentConfig) -> Optional[pmesh.Mesh]:
    """The mesh of the JAX package's routing (experiment.py:39-54):
    `mesh_shape=[d, l]` as given; otherwise a data mesh over `ndevices`
    (default: every rank) when that is more than one; else None, one
    device."""
    if cfg.mesh_shape is not None:
        if len(cfg.mesh_shape) != 2:
            raise ValueError(f"mesh_shape must be [n_data, n_lattice], got "
                             f"{list(cfg.mesh_shape)}")
        # n_lattice > 1: lattice-domain-decomposed SU(3)
        # (parallel/sharded_train.py)
        return pmesh.Mesh(int(cfg.mesh_shape[0]), int(cfg.mesh_shape[1]))
    ndev = cfg.ndevices or pmesh.world_size()
    if ndev > 1 or pmesh.world_size() > 1:
        return pmesh.Mesh(ndev, 1)
    return None


class Experiment:
    def __init__(self, cfg: ExperimentConfig, device=None):
        # join the process group before any device query, so each rank
        # takes its own card (reference experiment/pytorch/experiment.py:154)
        self.rank = pmesh.setup_distributed(device)
        self.is_main = self.rank == 0
        self.cfg = cfg
        self.mesh = build_mesh(cfg)
        self.trainer = Trainer(cfg, device=device, mesh=self.mesh)
        self.device = self.trainer.device
        self.outdir = cfg.outdir or os.path.join(
            "outputs", time.strftime("%Y-%m-%d-%H%M%S"))
        self.generator = torch.Generator(self.device).manual_seed(
            int(cfg.seed))
        self._x: Optional[torch.Tensor] = None
        self._start_era = 0
        self._beta_init: Optional[float] = None
        if (cfg.use_tb or cfg.use_wandb or cfg.init_aim) and self.is_main:
            from l2hmc_torch.utils.trackers import Trackers
            self.trainer.trackers = Trackers(
                self.outdir, use_tb=cfg.use_tb, use_wandb=cfg.use_wandb,
                use_aim=cfg.init_aim, config=cfg.to_dict(),
                run_name=cfg.name)

    # ------------------------------------------------------------------
    def setup(self) -> torch.Tensor:
        if self._x is not None:
            return self._x
        self._x = self.trainer.random_x(self.generator)
        if self.cfg.restore:
            tree = ckpt.restore_checkpoint(self.outdir,
                                           map_location=self.device)
            if tree is None:
                log.info(f"no checkpoint under {self.outdir}; starting "
                         "fresh")
            else:
                tr = self.trainer
                tr.dynamics.load_state_dict(tree["dynamics"])
                tr.load_optimizer_state(tree["optimizer"])
                tr.step = int(tree["step"])
                tr.updates = int(tree["updates"])
                tr.restore_accumulated_grads(tree.get("acc_grads"))
                self._x = self.trainer.shard(tree["x"].to(self.device))
                self.generator.set_state(tree["generator"].cpu())
                self._start_era = int(tree["era"]) + 1
                self._beta_init = float(tree["beta"])
                hpath = os.path.join(self.outdir, "train_history.npz")
                if os.path.exists(hpath):
                    tr.histories["train"].load(hpath)
                cpath = os.path.join(self.outdir, "controllers.json")
                if os.path.exists(cpath):
                    with open(cpath) as f:
                        tr.restore_controllers(json.load(f))
                log.info(f"restored checkpoint: resuming at era "
                         f"{self._start_era} (beta={self._beta_init:.3f})")
        return self._x

    def _era_checkpoint(self, era, x, beta):
        """Per-era durable state (reference trainer.py:1826-1829)."""
        if not self.cfg.save:
            return
        x = self.trainer.gather(x)     # a collective: every rank takes part
        if self.is_main:
            self._write_checkpoint(era, x, beta)
        if self.mesh is not None:
            # no rank runs ahead of the write (a resume reads it)
            self.mesh.barrier()

    def _write_checkpoint(self, era, x, beta):
        tree = ckpt.make_resume_tree(self.trainer, x, self.generator,
                                     era=era, beta=beta)
        ckpt.save_checkpoint(self.outdir, self.trainer.step, tree)
        ckpt.save_eps_txt(self.outdir, self.trainer.dynamics)
        self.trainer.histories["train"].save(self.outdir, "train")
        cstate = self.trainer.controller_state()
        if cstate:
            with open(os.path.join(self.outdir, "controllers.json"),
                      "w") as f:
                json.dump(cstate, f)

    def train(self, max_eras=None):
        x = self.setup()
        x = self.trainer.train(
            x, self.generator, start_era=self._start_era,
            beta_init=self._beta_init, max_eras=max_eras,
            era_callback=self._era_checkpoint)
        self._x = x
        if self.is_main:
            self.trainer.histories["train"].save(self.outdir, "train")
            self.trainer.timers["train"].save_and_write(self.outdir)
        return self.trainer.histories["train"]

    def evaluate(self, job_type: str = "eval", nsteps: Optional[int] = None,
                 dynamic_step_size: bool = False):
        """The HMC baseline runs at the fixed matched-cost step size
        eps_hmc = 1/nleapfrog (reference configs.py:485-487), so that
        `model_improvement` compares equal-budget samplers."""
        x = self.setup()
        self.trainer.evaluate(self.generator, job_type=job_type,
                              nsteps=nsteps, x=x,
                              dynamic_step_size=dynamic_step_size)
        if not self.is_main:
            return self.trainer.histories[job_type]
        self.trainer.histories[job_type].save(self.outdir, job_type)
        rates = self.trainer.timers[job_type].get_eval_rate()
        os.makedirs(self.outdir, exist_ok=True)
        with open(os.path.join(self.outdir, f"{job_type}_timer.json"),
                  "w") as f:
            json.dump(rates, f)
        return self.trainer.histories[job_type]

    def measure_improvement(self) -> float:
        """mean(dQint_eval) / mean(dQint_hmc), written to
        model_improvement.txt like the reference."""
        he = self.trainer.histories["eval"].get_dataset()
        hh = self.trainer.histories["hmc"].get_dataset()
        if "dQint" not in he or "dQint" not in hh:
            return float("nan")
        denom = float(np.mean(hh["dQint"]))
        improvement = float(np.mean(he["dQint"])) / max(denom, 1e-16)
        if not self.is_main:
            return improvement
        os.makedirs(self.outdir, exist_ok=True)
        with open(os.path.join(self.outdir, "model_improvement.txt"),
                  "w") as f:
            f.write(f"{improvement}\n")
        return improvement

    def sampler_stats(self, job_type: str) -> dict:
        """Acceptance, tunneling rate, tau_int and ESS of the topological
        charge series."""
        from l2hmc_torch.utils import autocorr as ac
        h = self.trainer.histories[job_type].get_dataset()
        out = {}
        if "acc" in h:
            out["acc"] = float(np.mean(h["acc"]))
        if "intQ" in h:
            q = np.atleast_2d(h["intQ"])
            out["dQint_rate"] = ac.tunneling_rate(q)
            if q.shape[-1] >= 8:
                out.update({f"intQ_{k}": v for k, v in
                            ac.chain_stats(q).items()
                            if k in ("tau_int", "ess_per_step")})
        if "dQint" in h:
            out["dQint"] = float(np.mean(h["dQint"]))
        if "dQsin" in h:
            out["dQsin"] = float(np.mean(h["dQsin"]))
        if "flowQ" in h:
            # Wilson-flowed clover charge (flow_nsteps > 0): near-integer
            # after flow, so its tunneling rate counts real topological
            # sector changes, which the imag-trace intQ cannot resolve
            q = np.atleast_2d(h["flowQ"])
            out["flowQ_mean_abs"] = float(np.mean(np.abs(q)))
            out["dQint_flow"] = ac.tunneling_rate(q)
            if q.shape[-1] >= 8:
                out.update({f"flowQ_{k}": v for k, v in
                            ac.chain_stats(np.round(q)).items()
                            if k in ("tau_int", "ess_per_step")})
        return out

    def run(self) -> dict:
        """Full pipeline (reference __main__.py:100-249)."""
        t0 = time.perf_counter()
        self.train()
        self.evaluate("eval")
        self.evaluate("hmc")
        improvement = self.measure_improvement()
        summary = {
            "improvement": improvement,
            "walltime": time.perf_counter() - t0,
            "train": self.trainer.timers["train"].get_eval_rate(),
            "eval": self.trainer.timers["eval"].get_eval_rate(),
            "hmc": self.trainer.timers["hmc"].get_eval_rate(),
            "eval_stats": self.sampler_stats("eval"),
            "hmc_stats": self.sampler_stats("hmc"),
        }
        if not self.is_main:
            return summary
        os.makedirs(self.outdir, exist_ok=True)
        with open(os.path.join(self.outdir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        self.make_plots()
        if self.trainer.trackers is not None:
            # final model as a wandb artifact (reference
            # __main__.py:197-241); a no-op for tb/aim-only runs
            ckpt_dir = os.path.join(self.outdir, "checkpoints")
            if os.path.isdir(ckpt_dir):
                self.trainer.trackers.log_artifact(ckpt_dir, name="model")
        log.info(f"model_improvement: {improvement:.3f}")
        return summary

    def make_plots(self) -> None:
        """End-of-job metric plots (reference common.py:732-900); nothing
        is written where matplotlib is missing."""
        from l2hmc_torch.utils import plots
        keys = ["loss", "acc", "dQint", "dQsin", "plaqs", "sumlogdet",
                "grad_norm"]
        for job in ("train", "eval", "hmc"):
            h = self.trainer.histories[job].get_dataset()
            if not h:
                continue
            d = os.path.join(self.outdir, "plots", job)
            plots.plot_history(h, d, logging_steps=1, keys=keys)
            if "intQ" in h and np.asarray(h["intQ"]).ndim >= 2:
                plots.plot_ridge(h["intQ"], "intQ", d)


def build_experiment(overrides: Optional[Sequence[str]] = None,
                     group: str = "U1", device=None) -> Experiment:
    """Programmatic entry (reference __main__.py:252-259). device defaults
    to the card; pass "cpu" to run on the CPU."""
    overrides = list(overrides or [])
    for ov in overrides:
        if ov.startswith("group="):
            group = ov.split("=", 1)[1]
    return Experiment(get_config(overrides, group=group), device=device)
