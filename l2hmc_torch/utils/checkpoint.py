"""Checkpoint save/restore with `torch.save`.

Counterpart of the JAX package's `utils/checkpoint.py` (after the
reference's per-era tar checkpoints, trainers/pytorch/trainer.py:573-701:
{era, epoch, xeps, veps, gstep, model_state_dict, optimizer_state_dict} +
restore-latest). One file per save under `<outdir>/checkpoints/`, written
atomically, holding the sampler's and the optimizer's state dicts plus
what a resumed run needs: the lattice x (complex for SU(3); `torch.save`
takes complex tensors as they are), the generator state, the era and the
beta reached, the step counters, and the partial sum of an open
gradient-accumulation window.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


def _ckpt_dir(outdir: str) -> str:
    return os.path.join(os.path.abspath(outdir), "checkpoints")


def save_checkpoint(outdir: str, step: int, tree: dict) -> str:
    d = _ckpt_dir(outdir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"ckpt_{int(step):08d}.pt")
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(outdir: str) -> Optional[str]:
    d = _ckpt_dir(outdir)
    if not os.path.isdir(d):
        return None
    cands = sorted(p for p in os.listdir(d)
                   if p.startswith("ckpt_") and p.endswith(".pt"))
    return os.path.join(d, cands[-1]) if cands else None


def restore_checkpoint(outdir: str, map_location=None) -> Optional[dict]:
    """The latest checkpoint's tree, or None when there is none."""
    path = latest_checkpoint(outdir)
    if path is None:
        return None
    return torch.load(path, map_location=map_location, weights_only=False)


def make_resume_tree(trainer: Any, x: torch.Tensor,
                     generator: torch.Generator, era: int = 0,
                     beta: float = 0.0) -> dict:
    """Full resumable training state."""
    return {
        "dynamics": trainer.dynamics.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "step": int(trainer.step),
        "updates": int(trainer.updates),
        "acc_grads": trainer.accumulated_grads(),
        "x": x.detach().cpu(),
        "generator": generator.get_state(),
        "era": int(era),
        "beta": float(beta),
    }


def save_eps_txt(outdir: str, dynamics) -> None:
    """Dump sigmoid(xeps)/sigmoid(veps) as text and npy, like the
    reference (dynamics/pytorch/dynamics.py:544-557)."""
    os.makedirs(outdir, exist_ok=True)
    for name in ("xeps", "veps"):
        arr = torch.sigmoid(getattr(dynamics, name).detach()).cpu().numpy()
        np.save(os.path.join(outdir, f"{name}.npy"), arr)
        np.savetxt(os.path.join(outdir, f"{name}.txt"), arr)
