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
(built and loaded at first use by `ops/kernels/library.py`) or raises; a
CPU tensor takes the plain version (`force_action_plain`,
`force_action_bwd_plain`).
There is no fallback from the kernel to the plain version.

A launch goes to PyTorch's current stream, never synchronises and does
its set-up once, so it can be captured in a CUDA graph (after one warm
call, which builds and loads the library). beta reaches the kernel as a
device operand, as it reaches the TPU kernel through SMEM: a 0-d tensor on
x's device is passed by pointer and read by the kernel when it runs, so a
graph captured at one beta replays at whatever value that tensor holds; a
Python number or a CPU scalar is first written into a device scalar.

Each launch is counted in `ops/kernels/launches.py` (`launch_counts()`
reads this module's two).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from l2hmc_torch.ops import lattice_u1 as lat
from l2hmc_torch.ops.kernels import launches, library
from l2hmc_torch.utils import spans

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "u1_force.cu"
#: shared memory one block can use on sm_90 (227 KB), less the kernels'
#: static shared memory (barriers, the reduction's per-warp partials)
SMEM_LIMIT = 232448 - 1024
#: least shared-memory words per site (one stage, one chain a block):
#: forward [xu, xv, sin W], backward [xu, xv, gF_u, gF_v, cos W * A gF]
FWD_WORDS, BWD_WORDS = 3, 5

NAMES = ("u1_force_fwd", "u1_force_bwd")
_p, _i = ctypes.c_void_p, ctypes.c_int
#: fwd (x, force, act, beta, nb, nt, nx), bwd (x, g_force, g_act, force,
#: x_bar, beta, nb, nt, nx)
LIB = library.Library(SOURCE, {NAMES[0]: [_p, _p, _p, _p, _i, _i, _i],
                               NAMES[1]: [_p] * 6 + [_i, _i, _i]})


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
# Wrappers
# ---------------------------------------------------------------------------
def beta_operand(beta, x: torch.Tensor) -> torch.Tensor:
    """beta as the kernel reads it: a contiguous 0-d tensor of x's dtype
    on x's device. A tensor on x's device is passed on (`library.beta`),
    never read on the host; a number or a CPU scalar is written into a new
    device scalar."""
    b = library.beta(beta, x)
    if isinstance(b, torch.Tensor):
        return b
    return torch.full((), b, dtype=x.dtype, device=x.device)


def _check_cuda(name: str, x: torch.Tensor, nt: int, nx: int,
                words: int, like=()) -> int:
    """Raise on what the kernel does not take; return the number of
    chains."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got "
                         f"{x.device}")
    if x.dtype not in library.SUFFIX:
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
    LIB.launch("u1_force_fwd", x, x.data_ptr(), force.data_ptr(),
               act.data_ptr(), beta.data_ptr(), nb, nt, nx)
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
    LIB.launch("u1_force_bwd", x, x.data_ptr(), g_force.data_ptr(),
               g_act.data_ptr() if with_act else None,
               force.data_ptr() if with_act else None, x_bar.data_ptr(),
               beta.data_ptr(), nb, nt, nx)
    return x_bar


def launch_counts() -> dict:
    return launches.counts(*NAMES)


def reset_launch_counts() -> None:
    launches.reset(*NAMES)


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
    beta = beta_operand(beta, x) if x.is_cuda else library.beta(beta, x)
    return ForceAction.apply(x, beta, nt, nx)
