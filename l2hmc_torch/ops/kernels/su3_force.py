"""Fused 4D SU(3) Wilson force and plaquette traces and their backward:
the CUDA wrappers.

One launch of the hand-written kernel in `csrc/su3_force.cu` computes what
the component engine's plain version (`ops/su3_comp.py`
`force_and_traces_plain`, ~1,100 PyTorch kernels a call) computes: for
links (re, im), each (3, 3, L) with L = 4 V nb in the engine's flat order
(d, t, x, y, z, nb),

    force_and_traces(re, im, beta, lat, nb)
        -> (force re, force im, per-chain sum of Re tr P over the 6 V
            plaquettes (nb,))

with force = projectTAH(U A) beta / 3, A the sum of the six staples, and
periodic neighbours. Each down term carries U_v^ U_v as the plain
version's shared-plaquette products do, so the two agree to rounding on
links off SU(3) too (a float32 hot start is off it by up to ~0.08).
`su3_comp.force_and_traces` chooses between the two (on the card, where
the roll is the engine's own, the autograd.Function below); these
wrappers take CUDA tensors only and raise on anything the kernel does not
take, a beta that wants a gradient included. There is no fallback from the
kernel to the plain version. re and im may be contiguous or views of one
complex lattice (every other value of its buffer, as
`su3_comp.from_complex_lattice` gives them where no copy is needed): the
kernel reads them at their `pitch`; the outputs are contiguous.

The library is built and loaded at its first call by
`ops/kernels/library.py`; nothing is built or loaded on import. A launch
goes to PyTorch's current stream, never synchronises and allocates its
outputs and its scratch (one double per block and chain) with
`torch.empty`, so it can be captured in a CUDA graph after one warm call.
beta reaches the kernel as a device operand: a 0-d tensor on the tensors'
device is passed by pointer and read when the kernel runs (a graph replays
at whatever value it then holds); a Python number or a CPU scalar is
passed by value, a constant of the launch, so no fill of a device scalar
is added to the call.

The trace sums are deterministic (a fixed-order reduction, no
floating-point atomics), so two launches on the same input give the same
bits. The final sum is made by the last block of a launch to finish,
found by an integer ticket that the library keeps in one device variable
per card: launches on one card must not overlap in time. The port keeps
to that, launching in order on PyTorch's current stream; two streams or
threads launching on one card at once would mix their tickets and leave
`tr` wrong. Launches are counted as `su3_force_fwd` in
`ops/kernels/launches.py`.

`force_and_traces_ad` is the differentiable pair: an autograd.Function
whose forward is the kernel above and whose backward is
`force_and_traces_bwd`, the VJP of the plain version with respect to the
links (two kernels of `csrc/su3_force.cu` in one call, counted once as
`su3_force_bwd`; no atomics, so two calls on one input give the same
bits). Where no input wants a gradient, autograd records nothing and the
call is the one forward launch. The Function saves only the links and
beta, which is shared by the two launches; the plain version's autograd
keeps ~94 MiB of intermediates a call at 8^4 x 8 float32. A cotangent
that was not used arrives as None and is not read; the backward cannot
itself be differentiated (no caller takes a second derivative of the
force).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from l2hmc_torch.ops.kernels import launches, library

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "su3_force.cu"
NAME, BWD = "su3_force_fwd", "su3_force_bwd"
_p, _i = ctypes.c_void_p, ctypes.c_int
#: fwd (re, im, pitch, f_re, f_im, tr, partial, partial's length, beta's
#: pointer or None, beta's value, the four extents, nb); bwd (re, im,
#: pitch, g_re, g_im, g_tr, pbar, pbar's length, x_re, x_im, beta's pointer
#: or None, beta's value, the four extents, nb)
LIB = library.Library(SOURCE, {
    NAME: [_p, _p, _i, _p, _p, _p, _p, ctypes.c_longlong, _p,
           ctypes.c_double, _i, _i, _i, _i, _i],
    BWD: [_p] * 7 + [ctypes.c_longlong, _p, _p, _p, ctypes.c_double,
                     _i, _i, _i, _i, _i]})


@functools.cache
def _threads() -> int:
    """The kernel's block size, as the library reports it."""
    fn = LIB.load().su3_force_threads
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def pitch(re: torch.Tensor, im: torch.Tensor) -> Optional[int]:
    """p where re and im are both (3, 3, L) with strides (3 L p, L p, p),
    the layouts the kernel reads; else None."""
    if re.dim() != 3 or tuple(re.shape[:2]) != (3, 3) \
            or re.shape != im.shape or re.stride() != im.stride():
        return None
    n, p = re.shape[2], re.stride(2)
    return p if p >= 1 and re.stride()[:2] == (3 * n * p, n * p) else None


def _check(re: torch.Tensor, im: torch.Tensor, lat: Sequence[int],
           nb: int, name: str = NAME) -> tuple[int, int]:
    """Raise on what kernel `name` does not take; return (L, pitch)."""
    if re.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {re.device}")
    if re.dtype not in library.SUFFIX:
        raise TypeError(f"{name}: dtype {re.dtype} not supported "
                        "(float32, float64)")
    if len(lat) != 4 or min(lat) < 1 or nb < 1:
        raise ValueError(f"{name}: needs a 4D lattice and chains, got "
                         f"{tuple(lat)} x {nb}")
    n = 4 * math.prod(lat) * nb
    # the backward's first pass indexes the 6 V nb = 1.5 L plaquettes
    if (3 * n // 2 if name == BWD else n) >= 2 ** 31 - 256:
        raise ValueError(f"{name}: {n} links; the kernel indexes fewer "
                         "than 2^31")
    p = pitch(re, im)
    if im.device != re.device or im.dtype != re.dtype or p is None \
            or tuple(re.shape) != (3, 3, n):
        raise ValueError(
            f"{name}: re and im must be {re.dtype} tensors on {re.device} "
            f"shaped (3, 3, {n}), contiguous or with one pitch; got "
            f"{tuple(re.shape)} {re.stride()}, {tuple(im.shape)} "
            f"{im.stride()} {im.dtype} on {im.device}")
    return n, p


def force_and_traces(re: torch.Tensor, im: torch.Tensor, beta,
                     lat: Sequence[int], nb: int):
    """(force re, force im, per-chain plaquette Re-trace sums): one launch
    of the CUDA kernel."""
    lat = tuple(int(n) for n in lat)
    n, p = _check(re, im, lat, nb)
    blocks = -(-n // _threads())
    f_re = torch.empty((3, 3, n), dtype=re.dtype, device=re.device)
    f_im = torch.empty_like(f_re)
    tr = re.new_empty((nb,))
    partial = torch.empty((blocks * nb,), dtype=torch.float64,
                          device=re.device)
    # a tensor on the links' device by pointer (held through the launch),
    # a number or a CPU scalar by value
    b = library.beta(beta, re)
    ptr, value = ((b.data_ptr(), 0.0) if isinstance(b, torch.Tensor)
                  else (None, b))
    LIB.launch(NAME, re, re.data_ptr(), im.data_ptr(), p, f_re.data_ptr(),
               f_im.data_ptr(), tr.data_ptr(), partial.data_ptr(),
               partial.numel(), ptr, value, *lat, nb)
    return f_re, f_im, tr


def force_and_traces_bwd(re: torch.Tensor, im: torch.Tensor,
                         g_re: Optional[torch.Tensor],
                         g_im: Optional[torch.Tensor],
                         g_tr: Optional[torch.Tensor], beta,
                         lat: Sequence[int], nb: int):
    """(x_bar re, x_bar im): the VJP of `su3_comp.force_and_traces_plain`
    with respect to the links (re, im) for the force cotangent (g_re,
    g_im), both None where the force was not used, and the trace
    cotangent g_tr (nb,) or None; one call of the backward's two kernels.
    The cotangents are read contiguous (copied where they are not)."""
    lat = tuple(int(n) for n in lat)
    n, p = _check(re, im, lat, nb, BWD)
    if (g_re is None) != (g_im is None):
        raise ValueError(f"{BWD}: g_re and g_im are both given or both "
                         "None")
    given = [(t, shape) for t, shape in ((g_re, (3, 3, n)), (g_im, (3, 3, n)),
                                         (g_tr, (nb,))) if t is not None]
    if any(t.device != re.device or t.dtype != re.dtype
           or tuple(t.shape) != shape for t, shape in given):
        raise ValueError(f"{BWD}: the cotangents must be {re.dtype} tensors "
                         f"on {re.device} shaped (3, 3, {n}) and ({nb},)")
    g_re, g_im, g_tr = (None if t is None else t.contiguous()
                        for t in (g_re, g_im, g_tr))
    x_re = torch.empty((3, 3, n), dtype=re.dtype, device=re.device)
    x_im = torch.empty_like(x_re)
    pbar = re.new_empty((27 * n,))     # 18 values x 6 planes x V nb sites
    b = library.beta(beta, re)
    ptr, value = ((b.data_ptr(), 0.0) if isinstance(b, torch.Tensor)
                  else (None, b))

    def addr(t):
        return None if t is None else t.data_ptr()
    LIB.launch(BWD, re, re.data_ptr(), im.data_ptr(), p, addr(g_re),
               addr(g_im), addr(g_tr), pbar.data_ptr(), pbar.numel(),
               x_re.data_ptr(), x_im.data_ptr(), ptr, value, *lat, nb)
    return x_re, x_im


class ForceAndTraces(torch.autograd.Function):
    """(force re, force im, traces) of the links (re, im), with
    `force_and_traces_bwd` as the VJP. beta is a non-trainable scalar (a
    device scalar is shared by the forward and the backward launch): no
    gradient is returned for it. An output that was not used arrives in
    backward as None, not as zeros."""

    @staticmethod
    def forward(ctx, re, im, beta, lat, nb):
        ctx.set_materialize_grads(False)
        f_re, f_im, tr = force_and_traces(re, im, beta, lat, nb)
        ctx.save_for_backward(re, im)
        ctx.beta, ctx.lat, ctx.nb = beta, lat, nb
        return f_re, f_im, tr

    @staticmethod
    @once_differentiable
    def backward(ctx, g_re, g_im, g_tr):
        if g_re is None and g_im is None and g_tr is None:
            return None, None, None, None, None
        re, im = ctx.saved_tensors
        # one half of the force used alone: the other's cotangent is zero
        if g_re is None and g_im is not None:
            g_re = torch.zeros_like(g_im)
        elif g_im is None and g_re is not None:
            g_im = torch.zeros_like(g_re)
        x_re, x_im = force_and_traces_bwd(re, im, g_re, g_im, g_tr, ctx.beta,
                                          ctx.lat, ctx.nb)
        return x_re, x_im, None, None, None


def force_and_traces_ad(re: torch.Tensor, im: torch.Tensor, beta,
                        lat: Sequence[int], nb: int):
    """Differentiable (force re, force im, traces): the forward kernel, and
    the backward kernels as its VJP."""
    return ForceAndTraces.apply(re, im, library.beta(beta, re),
                                tuple(int(n) for n in lat), nb)


def launch_counts() -> dict:
    return launches.counts(NAME, BWD)


def reset_launch_counts() -> None:
    launches.reset(NAME, BWD)
