"""Fused 4D SU(3) Wilson force and plaquette traces: the CUDA wrapper.

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
links off SU(3) too (a float32 hot start is off it by up to ~0.08). `su3_comp.force_and_traces` chooses between the two
(the kernel on the card where no gradient can be asked of the call and the
roll is the engine's own); this wrapper takes CUDA tensors only and raises
on anything the kernel does not take. There is no fallback from the
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
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Sequence

import torch

from l2hmc_torch.ops.kernels import launches, library

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "su3_force.cu"
NAME = "su3_force_fwd"
_p, _i = ctypes.c_void_p, ctypes.c_int
#: (re, im, pitch, f_re, f_im, tr, partial, partial's length, beta's
#: pointer or None, beta's value, the four extents, nb)
LIB = library.Library(SOURCE, {NAME: [
    _p, _p, _i, _p, _p, _p, _p, ctypes.c_longlong, _p, ctypes.c_double,
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
           nb: int) -> tuple[int, int]:
    """Raise on what the kernel does not take; return (L, pitch)."""
    if re.device.type != "cuda":
        raise ValueError(f"{NAME}: expected CUDA tensors, got {re.device}")
    if re.dtype not in library.SUFFIX:
        raise TypeError(f"{NAME}: dtype {re.dtype} not supported "
                        "(float32, float64)")
    if len(lat) != 4 or min(lat) < 1 or nb < 1:
        raise ValueError(f"{NAME}: needs a 4D lattice and chains, got "
                         f"{tuple(lat)} x {nb}")
    n = 4 * math.prod(lat) * nb
    if n >= 2 ** 31 - 256:
        raise ValueError(f"{NAME}: {n} links; the kernel indexes fewer "
                         "than 2^31")
    p = pitch(re, im)
    if im.device != re.device or im.dtype != re.dtype or p is None \
            or tuple(re.shape) != (3, 3, n):
        raise ValueError(
            f"{NAME}: re and im must be {re.dtype} tensors on {re.device} "
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


def launch_counts() -> dict:
    return launches.counts(NAME)


def reset_launch_counts() -> None:
    launches.reset(NAME)
