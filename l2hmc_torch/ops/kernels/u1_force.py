"""Fused U(1) force/action kernel and its backward: CUDA wrappers and
plain PyTorch versions.

Replaces the JAX package's Pallas TPU kernel
(`ops/pallas/u1_kernels.py::_kernel` there, via `force_action_t`,
`force_action`, `force_action_ad`) and its custom VJP `_fa_bwd`. For a
chain-first x of shape (nb, 2*nt*nx) or (nb, 2, nt, nx):

    force_action(x, beta, nt, nx)  -> (F = beta A^T sin(A x), S (nb,))
    force_action_bwd(x, gF, gS, F, beta, nt, nx)
                                   -> x_bar = beta A^T(cos(A x) * A gF) + gS F
                                      (gS may be None: no gS F term, and F
                                      is not read)
    force_action_ad(x, beta, nt, nx)  the differentiable pair (an
                                   autograd.Function over the two above)

A CUDA tensor launches the hand-written kernel in `csrc/u1_force.cu`
(built with nvcc at first use, loaded with ctypes) or raises; a CPU tensor
takes the plain version (`force_action_plain`, `force_action_bwd_plain`).
There is no fallback from the kernel to the plain version.

A launch goes to PyTorch's current stream, never synchronises and does
its set-up once, so it can be captured in a CUDA graph (after one warm
call, which builds and loads the library). beta reaches the kernel as a
device operand, as it reaches the TPU kernel through SMEM: a 0-d tensor on
x's device is passed by pointer and read by the kernel when it runs, so a
graph captured at one beta replays at whatever value that tensor holds; a
Python number or a CPU scalar is first written into a device scalar.

Each wrapper counts its kernel's launches in `ops/kernels/launches.py`
(`launch_counts()` reads this module's two); `captured_launches` and
`count_replay` are that registry's `captured` and `count_replay`.
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
from l2hmc_torch.ops.kernels import launches
from l2hmc_torch.utils import spans

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCE = CSRC / "u1_force.cu"
#: build output, under the checkout root (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "l2hmc_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
#: shared memory one block can use on sm_90 (227 KB), less the kernels'
#: static shared memory (barriers, the reduction's per-warp partials)
SMEM_LIMIT = 232448 - 1024
#: least shared-memory words per site (one stage, one chain a block):
#: forward [xu, xv, sin W], backward [xu, xv, gF_u, gF_v, cos W * A gF]
FWD_WORDS, BWD_WORDS = 3, 5

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
NAMES = ("u1_force_fwd", "u1_force_bwd")
launches.register(*NAMES)
#: the loaded library's entry points by dtype, filled by _load()
_FWD: dict = {}
_BWD: dict = {}
_ERROR_STRING: list = []


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------
def force_action_plain(x: torch.Tensor, beta, nt: int, nx: int):
    """(force like x, action (nb,)) from wilson_loops + plaq_adjoint."""
    w = lat.wilson_loops(x, nt, nx)
    force = beta * lat.plaq_adjoint(torch.sin(w), x.shape)
    return force, lat.action_from_wloops(w, beta)


def force_action_bwd_plain(x: torch.Tensor, g_force: torch.Tensor,
                           g_act: Optional[torch.Tensor],
                           force: Optional[torch.Tensor], beta,
                           nt: int, nx: int) -> torch.Tensor:
    """x_bar = beta A^T(cos W * A gF) + gS F — a transcription of the JAX
    package's `_fa_bwd` (u1_kernels.py:126-138). With g_act None the gS F
    term is left out and force is not used."""
    w = lat.wilson_loops(x, nt, nx)
    h = lat.wilson_loops(g_force, nt, nx)      # A gF (the same linear map)
    x_bar = beta * lat.plaq_adjoint(torch.cos(w) * h, x.shape)
    if g_act is None:
        return x_bar
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
            "/usr/local/cuda and $PATH): the port's CUDA kernels cannot be "
            "built, so CUDA tensors cannot take their paths")
    return found


def build_inputs(csrc: Path = CSRC) -> list[Path]:
    """Every file the build reads: the sources and headers under csrc."""
    return sorted(p for p in csrc.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def library_path(csrc: Path = CSRC) -> Path:
    """The .so for the current sources, headers and flags (keyed by their
    hash, so a stale build is never loaded)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in build_inputs(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"u1_force_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, source: Path = SOURCE,
          path: Optional[Path] = None) -> tuple[Path, str]:
    """Compile `source` (csrc/u1_force.cu) into `path` (by default this
    source's `library_path()`) unless that build exists. Returns (library
    path, compiler output); verbose adds -Xptxas -v (registers, shared
    memory, spills per kernel) to a fresh build."""
    path = library_path() if path is None else path
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(source)]
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


def _load() -> None:
    """Build if needed, load the library and resolve its entry points once
    per dtype."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for dtype, sfx in _SUFFIX.items():
        fwd = getattr(lib, f"u1_force_fwd_{sfx}")
        fwd.argtypes = [p, p, p, p, i, i, i, i, p]
        fwd.restype = i
        bwd = getattr(lib, f"u1_force_bwd_{sfx}")
        bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        bwd.restype = i
        _FWD[dtype], _BWD[dtype] = fwd, bwd
    lib.u1_force_error_string.argtypes = [i]
    lib.u1_force_error_string.restype = ctypes.c_char_p
    _ERROR_STRING.append(lib.u1_force_error_string)


def _raise_launch_error(name: str, rc: int):
    what = _ERROR_STRING[0](rc).decode()
    raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({what})")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def _beta_arg(beta):
    """beta as given (a number or a tensor), refused if it wants a
    gradient."""
    if isinstance(beta, torch.Tensor) and beta.requires_grad:
        raise ValueError(
            "beta is a non-trainable scalar here: the force kernel's "
            "autograd.Function returns no gradient for it")
    return beta


def beta_operand(beta, x: torch.Tensor) -> torch.Tensor:
    """beta as the kernel reads it: a contiguous 0-d tensor of x's dtype
    on x's device. A tensor on x's device is passed on (cast if its dtype
    differs), never read on the host; a number or a CPU scalar is written
    into a new device scalar."""
    beta = _beta_arg(beta)
    if isinstance(beta, torch.Tensor) and beta.device == x.device:
        if beta.numel() != 1:
            raise ValueError(f"beta must be one value, got shape "
                             f"{tuple(beta.shape)}")
        return beta.reshape(()).to(x.dtype).contiguous()
    if isinstance(beta, torch.Tensor) and beta.device.type != "cpu":
        raise ValueError(f"beta is on {beta.device}, x on {x.device}")
    return torch.full((), float(beta), dtype=x.dtype, device=x.device)


def _check_cuda(name: str, x: torch.Tensor, nt: int, nx: int,
                words: int, like=()) -> int:
    """Raise on what the kernel does not take; return the number of
    chains."""
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
    for t in like:
        if t.device != x.device or t.dtype != x.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: every input must be a contiguous "
                             f"{x.dtype} tensor on {x.device}")
    return nb


def _raw_stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on x's device, as the integer handle (no
    Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


@spans.span("u1.force")
def force_action(x: torch.Tensor, beta, nt: int, nx: int):
    """Force and action: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return force_action_plain(x, beta, nt, nx)
    nb = _check_cuda("u1_force_fwd", x, nt, nx, FWD_WORDS)
    beta = beta_operand(beta, x)
    force = torch.empty_like(x)
    act = x.new_empty((nb,))
    if nb == 0:
        return force, act
    if not _FWD:
        _load()
    rc = _FWD[x.dtype](x.data_ptr(), force.data_ptr(), act.data_ptr(),
                       beta.data_ptr(), nb, nt, nx, x.device.index,
                       _raw_stream(x))
    if rc != 0:
        _raise_launch_error("u1_force_fwd", rc)
    launches.add("u1_force_fwd")
    return force, act


def force_action_bwd(x: torch.Tensor, g_force: torch.Tensor,
                     g_act: Optional[torch.Tensor],
                     force: Optional[torch.Tensor], beta,
                     nt: int, nx: int) -> torch.Tensor:
    """x_bar of (force, action) w.r.t. x: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. With g_act None (the
    action was not used) force is neither needed nor read."""
    if x.device.type == "cpu":
        return force_action_bwd_plain(x, g_force, g_act, force, beta, nt, nx)
    with_act = g_act is not None
    nb = _check_cuda("u1_force_bwd", x, nt, nx, BWD_WORDS,
                     like=(g_force, g_act, force) if with_act
                     else (g_force,))
    if g_force.shape != x.shape or (with_act and (
            force.shape != x.shape or tuple(g_act.shape) != (nb,))):
        raise ValueError("u1_force_bwd: g_force and force must be shaped "
                         "like x and g_act (nb,)")
    beta = beta_operand(beta, x)
    x_bar = torch.empty_like(x)
    if nb == 0:
        return x_bar
    if not _BWD:
        _load()
    rc = _BWD[x.dtype](x.data_ptr(), g_force.data_ptr(),
                       g_act.data_ptr() if with_act else None,
                       force.data_ptr() if with_act else None,
                       x_bar.data_ptr(), beta.data_ptr(), nb, nt, nx,
                       x.device.index, _raw_stream(x))
    if rc != 0:
        _raise_launch_error("u1_force_bwd", rc)
    launches.add("u1_force_bwd")
    return x_bar


def launch_counts() -> dict:
    return launches.counts(*NAMES)


def reset_launch_counts() -> None:
    launches.reset(*NAMES)


captured_launches = launches.captured
count_replay = launches.count_replay


class ForceAction(torch.autograd.Function):
    """(force, action) of x with the backward kernel as its VJP. beta is
    a non-trainable scalar (on the card a device scalar, shared by the
    forward and the backward launch): no gradient is returned for it. An output
    that was not used arrives in backward as None, not as zeros: without
    g_act the kernel skips the gS F term and never reads F."""

    @staticmethod
    def forward(ctx, x, beta, nt, nx):
        ctx.set_materialize_grads(False)
        force, act = force_action(x, beta, nt, nx)
        ctx.save_for_backward(x, force)
        ctx.beta, ctx.nt, ctx.nx = beta, nt, nx
        return force, act

    @staticmethod
    def backward(ctx, g_force, g_act):
        if g_force is None and g_act is None:
            return None, None, None, None
        x, force = ctx.saved_tensors
        # only the action was used (not on the training path): the same
        # kernel with a zero g_force
        g_force = torch.zeros_like(x) if g_force is None \
            else g_force.contiguous()
        if g_act is not None:
            g_act = g_act.contiguous()
        x_bar = force_action_bwd(x, g_force, g_act, force, ctx.beta, ctx.nt,
                                 ctx.nx)
        return x_bar, None, None, None


def force_action_ad(x: torch.Tensor, beta, nt: int, nx: int):
    """Differentiable (force, action); the port's counterpart of
    `u1_kernels.force_action_ad`."""
    x = x.contiguous()
    beta = beta_operand(beta, x) if x.is_cuda else _beta_arg(beta)
    return ForceAction.apply(x, beta, nt, nx)
