"""Experiment orchestration: train -> eval -> HMC baseline -> improvement.

PyTorch counterpart of the JAX package's `experiment.py` (after the
reference's Experiment + __main__ pipeline, src/l2hmc/__main__.py:100-249):
build everything from an ExperimentConfig, train with the beta ladder,
evaluate the trained sampler, run the matched-cost HMC baseline, and report
`model_improvement = mean(dQint_eval) / mean(dQint_hmc)`.

Runs on one device, the card unless `device="cpu"` is asked for. All
random draws come from one `torch.Generator` on that device, seeded from
`cfg.seed`; the network weights and masks come from a CPU generator of the
same seed, so they do not depend on the device.
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
from l2hmc_torch.train.trainer import Trainer
from l2hmc_torch.utils import checkpoint as ckpt

log = logging.getLogger(__name__)


class Experiment:
    def __init__(self, cfg: ExperimentConfig, device=None):
        self.cfg = cfg
        self.trainer = Trainer(cfg, device=device)
        self.device = self.trainer.device
        self.outdir = cfg.outdir or os.path.join(
            "outputs", time.strftime("%Y-%m-%d-%H%M%S"))
        self.generator = torch.Generator(self.device).manual_seed(
            int(cfg.seed))
        self._x: Optional[torch.Tensor] = None
        self._start_era = 0
        self._beta_init: Optional[float] = None

    # ------------------------------------------------------------------
    def setup(self) -> torch.Tensor:
        if self._x is not None:
            return self._x
        self._x = self.trainer.dynamics.random_x(self.generator)
        if self.cfg.restore:
            tree = ckpt.restore_checkpoint(self.outdir,
                                           map_location=self.device)
            if tree is None:
                log.info(f"no checkpoint under {self.outdir}; starting "
                         "fresh")
            else:
                tr = self.trainer
                tr.dynamics.load_state_dict(tree["dynamics"])
                tr.optimizer.load_state_dict(tree["optimizer"])
                tr.step = int(tree["step"])
                tr.updates = int(tree["updates"])
                self._x = tree["x"].to(self.device)
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
        os.makedirs(self.outdir, exist_ok=True)
        with open(os.path.join(self.outdir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        self.make_plots()
        log.info(f"model_improvement: {improvement:.3f}")
        return summary

    def make_plots(self) -> None:
        """End-of-job plots: a no-op until the plots module is ported."""


def build_experiment(overrides: Optional[Sequence[str]] = None,
                     group: str = "U1", device=None) -> Experiment:
    """Programmatic entry (reference __main__.py:252-259). device defaults
    to the card; pass "cpu" to run on the CPU."""
    overrides = list(overrides or [])
    for ov in overrides:
        if ov.startswith("group="):
            group = ov.split("=", 1)[1]
    if group.upper() != "U1":
        raise NotImplementedError(
            f"group={group} is not ported to l2hmc_torch yet (only U1)")
    return Experiment(get_config(overrides, group=group), device=device)
