"""Fused U(1) force/action kernel and its backward: CUDA wrappers and
plain PyTorch versions.

Replaces the JAX package's Pallas TPU kernel
(`ops/pallas/u1_kernels.py::_kernel` there, via `force_action_t`,
`force_action`, `force_action_ad`) and its custom VJP `_fa_bwd`. For a
chain-first x of shape (nb, 2*nt*nx) or (nb, 2, nt, nx):

    force_action(x, beta, nt, nx)  -> (F = beta A^T sin(A x), S (nb,))
    force_action_bwd(x, gF, gS, F, beta, nt, nx)
                                   -> x_bar = beta A^T(cos(A x) * A gF) + gS F
    force_action_ad(x, beta, nt, nx)  the differentiable pair (an
                                   autograd.Function over the two above)

A CUDA tensor launches the hand-written kernel in `csrc/u1_force.cu`
(built with nvcc at first use, loaded with ctypes) or raises; a CPU tensor
takes the plain version (`force_action_plain`, `force_action_bwd_plain`).
There is no fallback from the kernel to the plain version.

Each wrapper counts its kernel launches in a plain int attribute
(`force_action.launches`, `force_action_bwd.launches`), so a run can
show that its force evaluations went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from l2hmc_torch.ops import lattice_u1 as lat

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "u1_force.cu"
#: build output, under the checkout root (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "l2hmc_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
#: shared memory one block can use on sm_90 (227 KB), less the kernels'
#: static shared memory (the reduction's per-warp partials)
SMEM_LIMIT = 232448 - 1024
#: shared-memory words per site: forward [xu, xv, sin W], backward
#: [xu, xv, gF_u, gF_v, cos W * A gF]
FWD_WORDS, BWD_WORDS = 3, 5

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_LIB: dict = {}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------
def force_action_plain(x: torch.Tensor, beta, nt: int, nx: int):
    """(force like x, action (nb,)) from wilson_loops + plaq_adjoint."""
    w = lat.wilson_loops(x, nt, nx)
    force = beta * lat.plaq_adjoint(torch.sin(w), x.shape)
    return force, lat.action_from_wloops(w, beta)


def force_action_bwd_plain(x: torch.Tensor, g_force: torch.Tensor,
                           g_act: torch.Tensor, force: torch.Tensor, beta,
                           nt: int, nx: int) -> torch.Tensor:
    """x_bar = beta A^T(cos W * A gF) + gS F — a transcription of the JAX
    package's `_fa_bwd` (u1_kernels.py:126-138)."""
    w = lat.wilson_loops(x, nt, nx)
    h = lat.wilson_loops(g_force, nt, nx)      # A gF (the same linear map)
    x_bar = beta * lat.plaq_adjoint(torch.cos(w) * h, x.shape)
    return x_bar + g_act.reshape(-1, *([1] * (x.dim() - 1))) * force


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and $PATH): the U(1) force kernel cannot be "
            "built, so CUDA tensors cannot take the force path")
    return found


def library_path() -> Path:
    """The .so for the current source and flags (keyed by their hash, so
    a stale build is never loaded)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"u1_force_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile csrc/u1_force.cu unless this source's build exists.
    Returns (library path, compiler output); verbose adds -Xptxas -v
    (registers, shared memory, spills per kernel) to a fresh build."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(SOURCE)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, path)     # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, r.stdout + r.stderr


def _lib() -> ctypes.CDLL:
    if "lib" not in _LIB:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        p, d, i = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
        for sfx in _SUFFIX.values():
            fwd = getattr(lib, f"u1_force_fwd_{sfx}")
            fwd.argtypes = [p, p, p, d, i, i, i, i, p]
            fwd.restype = i
            bwd = getattr(lib, f"u1_force_bwd_{sfx}")
            bwd.argtypes = [p, p, p, p, p, d, i, i, i, i, p]
            bwd.restype = i
        _LIB["lib"] = lib
    return _LIB["lib"]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def _beta_value(beta) -> float:
    if isinstance(beta, torch.Tensor) and beta.requires_grad:
        raise ValueError(
            "beta is a non-trainable scalar here: the force kernel's "
            "autograd.Function returns no gradient for it")
    return float(beta)


def _check_cuda(name: str, x: torch.Tensor, nt: int, nx: int,
                words: int, like: Optional[torch.Tensor] = None):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got "
                         f"{x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32, float64)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    nb = x.shape[0]
    if tuple(x.shape) not in ((nb, 2 * nt * nx), (nb, 2, nt, nx)):
        raise ValueError(f"{name}: shape {tuple(x.shape)} is neither "
                         f"(nb, {2 * nt * nx}) nor (nb, 2, {nt}, {nx})")
    smem = words * nt * nx * x.element_size()
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: a {nt}x{nx} {x.dtype} lattice needs {smem} bytes of "
            f"shared memory per block; at most {SMEM_LIMIT} fit")
    if like is not None:
        for t in like:
            if t.device != x.device or t.dtype != x.dtype \
                    or not t.is_contiguous():
                raise ValueError(f"{name}: every input must be a contiguous "
                                 f"{x.dtype} tensor on {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def force_action(x: torch.Tensor, beta, nt: int, nx: int):
    """Force and action: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return force_action_plain(x, beta, nt, nx)
    _check_cuda("u1_force_fwd", x, nt, nx, FWD_WORDS)
    nb = x.shape[0]
    force = torch.empty_like(x)
    act = torch.empty((nb,), dtype=x.dtype, device=x.device)
    if nb == 0:
        return force, act
    fn = getattr(_lib(), f"u1_force_fwd_{_SUFFIX[x.dtype]}")
    rc = fn(x.data_ptr(), force.data_ptr(), act.data_ptr(),
            _beta_value(beta), nb, nt, nx, x.device.index, _stream(x))
    if rc != 0:
        raise RuntimeError(f"u1_force_fwd launch failed: CUDA error {rc}")
    force_action.launches += 1
    return force, act


def force_action_bwd(x: torch.Tensor, g_force: torch.Tensor,
                     g_act: torch.Tensor, force: torch.Tensor, beta,
                     nt: int, nx: int) -> torch.Tensor:
    """x_bar of (force, action) w.r.t. x: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return force_action_bwd_plain(x, g_force, g_act, force, beta, nt, nx)
    _check_cuda("u1_force_bwd", x, nt, nx, BWD_WORDS,
                like=(g_force, g_act, force))
    nb = x.shape[0]
    if g_force.shape != x.shape or force.shape != x.shape \
            or tuple(g_act.shape) != (nb,):
        raise ValueError("u1_force_bwd: g_force and force must be shaped "
                         "like x and g_act (nb,)")
    x_bar = torch.empty_like(x)
    if nb == 0:
        return x_bar
    fn = getattr(_lib(), f"u1_force_bwd_{_SUFFIX[x.dtype]}")
    rc = fn(x.data_ptr(), g_force.data_ptr(), g_act.data_ptr(),
            force.data_ptr(), x_bar.data_ptr(), _beta_value(beta), nb, nt,
            nx, x.device.index, _stream(x))
    if rc != 0:
        raise RuntimeError(f"u1_force_bwd launch failed: CUDA error {rc}")
    force_action_bwd.launches += 1
    return x_bar


force_action.launches = 0
force_action_bwd.launches = 0


def launch_counts() -> dict:
    return {"u1_force_fwd": force_action.launches,
            "u1_force_bwd": force_action_bwd.launches}


def reset_launch_counts() -> None:
    force_action.launches = 0
    force_action_bwd.launches = 0


class ForceAction(torch.autograd.Function):
    """(force, action) of x with the backward kernel as its VJP. beta is
    a non-trainable scalar: no gradient is returned for it."""

    @staticmethod
    def forward(ctx, x, beta, nt, nx):
        force, act = force_action(x, beta, nt, nx)
        ctx.save_for_backward(x, force)
        ctx.beta, ctx.nt, ctx.nx = beta, nt, nx
        return force, act

    @staticmethod
    def backward(ctx, g_force, g_act):
        x, force = ctx.saved_tensors
        x_bar = force_action_bwd(x, g_force.contiguous(),
                                 g_act.contiguous(), force, ctx.beta,
                                 ctx.nt, ctx.nx)
        return x_bar, None, None, None


def force_action_ad(x: torch.Tensor, beta, nt: int, nx: int):
    """Differentiable (force, action); the port's counterpart of
    `u1_kernels.force_action_ad`."""
    return ForceAction.apply(x.contiguous(), _beta_value(beta), nt, nx)
