"""Experiment tracking fan-out: TensorBoard / Weights & Biases / Aim.

PyTorch counterpart of the JAX package's `utils/trackers.py`, after the
reference's triple metric sink
(reference src/l2hmc/trackers/pytorch/trackers.py:198-281
`update_summaries`, experiment/experiment.py:104-235 wandb/aim init).
Every backend is optional and soft-imported: missing packages degrade to
no-ops so headless nodes run clean. `update_summaries` takes the same
flat metric dict the Trainer produces.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from l2hmc_torch.utils.history import grab


class Trackers:
    def __init__(self, outdir: str, use_tb: bool = False,
                 use_wandb: bool = False, use_aim: bool = False,
                 config: Optional[dict] = None, run_name: Optional[str] = None):
        self.outdir = outdir
        self.tb = None
        self.wandb = None
        self.aim = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(log_dir=os.path.join(outdir, "tb"))
            except ImportError:
                try:
                    from tensorboardX import SummaryWriter
                    self.tb = SummaryWriter(
                        log_dir=os.path.join(outdir, "tb"))
                except ImportError:
                    pass
        if use_wandb:
            try:
                import wandb
                self.wandb = wandb.init(
                    project="l2hmc-tpu", dir=outdir, config=config,
                    name=run_name)
            except Exception:
                self.wandb = None
        if use_aim:
            try:
                import aim
                self.aim = aim.Run(repo=outdir)
                if config:
                    self.aim["config"] = config
            except Exception:
                self.aim = None

    def update_summaries(self, metrics: dict[str, Any], step: int,
                         job_type: str = "train") -> None:
        """Log scalars (means) + small-array histograms to every active
        sink (trackers/pytorch/trackers.py:198-281)."""
        scalars = {}
        arrays = {}
        for k, v in metrics.items():
            if v is None or k == "mc_states":
                continue
            try:
                a = grab(v)
            except (TypeError, ValueError):
                continue
            if a.ndim == 0:
                scalars[k] = float(a)
            else:
                scalars[k] = float(np.mean(a))
                if a.size <= 65536:
                    arrays[k] = a
        if self.tb is not None:
            for k, val in scalars.items():
                self.tb.add_scalar(f"{job_type}/{k}", val, step)
            for k, a in arrays.items():
                try:
                    self.tb.add_histogram(f"{job_type}/{k}", a, step)
                except Exception:
                    pass
        if self.wandb is not None:
            self.wandb.log(
                {f"{job_type}/{k}": v for k, v in scalars.items()},
                step=step)
        if self.aim is not None:
            for k, val in scalars.items():
                self.aim.track(val, name=k, step=step,
                               context={"job": job_type})

    def log_params(self, module: Any, step: int, grads: bool = True,
                   prefix: str = "model") -> None:
        """Parameter (and gradient) histograms + norms for every entry of
        `module.named_parameters()` and its `.grad`: the reference's
        wandb.watch/log_item histogram pass
        (trackers/pytorch/trackers.py:167-196). Call on a logging cadence
        only; every tensor is pulled to the host."""
        if self.tb is None and self.wandb is None and self.aim is None:
            return

        def each(named, tag):
            for pname, leaf in named:
                name = f"{prefix}/{tag}/{pname}"
                a = grab(leaf).ravel()
                if a.size == 0:
                    continue
                if self.tb is not None:
                    try:
                        self.tb.add_histogram(name, a, step)
                    except Exception:
                        pass
                    self.tb.add_scalar(f"{name}.norm",
                                       float(np.linalg.norm(a)), step)
                if self.wandb is not None:
                    try:
                        import wandb
                        self.wandb.log({name: wandb.Histogram(a)}, step=step)
                    except Exception:
                        pass
                if self.aim is not None:
                    try:
                        from aim import Distribution
                        self.aim.track(Distribution(a), name=name, step=step)
                    except Exception:
                        pass

        named = list(module.named_parameters())
        each(named, "param")
        if grads:
            each([(n, p.grad) for n, p in named if p.grad is not None],
                 "grad")

    def log_artifact(self, path: str, name: str = "model",
                     kind: str = "model") -> None:
        """Upload a file/directory as a wandb artifact — the reference
        pushes the final checkpoint this way
        (reference src/l2hmc/__main__.py:197-241). No-op without wandb."""
        if self.wandb is None:
            return
        try:
            import wandb
            art = wandb.Artifact(name, type=kind)
            if os.path.isdir(path):
                art.add_dir(path)
            else:
                art.add_file(path)
            self.wandb.log_artifact(art)
        except Exception:
            pass

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()
        if self.aim is not None:
            self.aim.close()
