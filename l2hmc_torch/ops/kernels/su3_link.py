"""The SU(3) engine's per-link maps `expm` and `reunit`: the CUDA wrapper.

One launch of a hand-written kernel in `csrc/su3_link.cu` computes what
the component engine's plain body (`ops/su3_comp.py` `expm`, ~240 PyTorch
kernels a call at order 8, and `reunit`, ~330) computes, for a field
(re, im) of 3x3 complex matrices, each (3, 3, L):

    expm(re, im, order, s) -> (re', im')   exp by the scaling-squaring
        Taylor recurrence on y = exp(m) - 1, in the plain body's order
    reunit(re, im)         -> (re', im')   x (x^ x)^(-1/2) by three
        Newton-Schulz steps, its determinant's phase removed

`su3_comp.expm` and `su3_comp.reunit` choose between each kernel and the
plain body (the kernel on the card where no gradient can be asked of the
call); these wrappers take CUDA tensors only and raise on anything the
kernels do not take. There is no fallback from a kernel to the plain body.
re and im may have any strides (contiguous planes, views of one complex
lattice, permuted views): the kernels read them where they lie, so no
copy goes into the call; the outputs are contiguous.

The library is built and loaded at its first call by
`ops/kernels/library.py`; nothing is built or loaded on import. A launch
goes to PyTorch's current stream, never synchronises and allocates its
outputs with `torch.empty`, so it can be captured in a CUDA graph after
one warm call. Neither kernel reduces across matrices, so two launches on
one input give the same bits. Launches are counted as `su3_expm_fwd` and
`su3_reunit_fwd` in `ops/kernels/launches.py`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from l2hmc_torch.ops.kernels import launches, library

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "su3_link.cu"
EXPM, REUNIT = "su3_expm_fwd", "su3_reunit_fwd"
#: the kernels index fewer than 2^31 matrices (less a block)
_MAX_L = 2 ** 31 - 1 - 128
_p, _ll = ctypes.c_void_p, ctypes.c_longlong
#: (re, re's strides, im, im's strides, out re, out im, L), then expm's
#: order and squarings
_HEAD = [_p, ctypes.POINTER(_ll), _p, ctypes.POINTER(_ll), _p, _p, _ll]
LIB = library.Library(SOURCE, {EXPM: _HEAD + [ctypes.c_int] * 2,
                               REUNIT: _HEAD})


def _check(name: str, re: torch.Tensor, im: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return L."""
    if re.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {re.device}")
    if re.dtype not in library.SUFFIX:
        raise TypeError(f"{name}: dtype {re.dtype} not supported "
                        "(float32, float64)")
    if im.device != re.device or im.dtype != re.dtype or re.dim() != 3 \
            or tuple(re.shape[:2]) != (3, 3) or im.shape != re.shape:
        raise ValueError(
            f"{name}: re and im must be {re.dtype} tensors on {re.device} "
            f"shaped (3, 3, L); got {tuple(re.shape)}, {tuple(im.shape)} "
            f"{im.dtype} on {im.device}")
    n = re.shape[2]
    if n > _MAX_L:
        raise ValueError(f"{name}: {n} matrices; the kernels index fewer "
                         "than 2^31")
    return n


def _launch(name: str, re: torch.Tensor, im: torch.Tensor, *extra):
    n = _check(name, re, im)
    out_re = torch.empty((3, 3, n), dtype=re.dtype, device=re.device)
    out_im = torch.empty_like(out_re)
    sr = (_ll * 3)(*re.stride())
    si = (_ll * 3)(*im.stride())
    LIB.launch(name, re, re.data_ptr(), sr, im.data_ptr(), si,
               out_re.data_ptr(), out_im.data_ptr(), n, *extra)
    return out_re, out_im


def expm(re: torch.Tensor, im: torch.Tensor, order: int, s: int):
    """(re', im') of exp(m), m = (re, im): one launch of the CUDA kernel."""
    order, s = int(order), int(s)
    if order < 1 or not 0 <= s <= 60:
        raise ValueError(f"{EXPM}: needs order >= 1 and 0 <= s <= 60, got "
                         f"order {order}, s {s}")
    return _launch(EXPM, re, im, order, s)


def reunit(re: torch.Tensor, im: torch.Tensor):
    """(re', im') of x (x^ x)^(-1/2), det-phase-fixed: one launch of the
    CUDA kernel."""
    return _launch(REUNIT, re, im)


def launch_counts() -> dict:
    return launches.counts(EXPM, REUNIT)


def reset_launch_counts() -> None:
    launches.reset(EXPM, REUNIT)
