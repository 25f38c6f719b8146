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

The library is built with nvcc at its first call (`u1_force.build`, keyed
by a hash of this source and the flags, under `build/`) and loaded with
ctypes; nothing is built or loaded on import. A launch goes to PyTorch's
current stream, never synchronises and allocates its outputs with
`torch.empty`, so it can be captured in a CUDA graph after one warm call.
Neither kernel reduces across matrices, so two launches on one input give
the same bits. Launches are counted as `su3_expm_fwd` and
`su3_reunit_fwd` in `ops/kernels/launches.py`.
"""
from __future__ import annotations

import ctypes
import hashlib
from pathlib import Path

import torch

from l2hmc_torch.ops.kernels import launches, u1_force

SOURCE = u1_force.CSRC / "su3_link.cu"
EXPM, REUNIT = "su3_expm_fwd", "su3_reunit_fwd"
launches.register(EXPM, REUNIT)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: the kernels index fewer than 2^31 matrices (less a block)
_MAX_L = 2 ** 31 - 1 - 128
#: the loaded library: entry points by (name, dtype) and the error
#: string, filled by _load()
_LIB: dict = {}


def library_path() -> Path:
    """The .so for this source and the U(1) build's flags (keyed by their
    hash, so a stale build is never loaded)."""
    h = hashlib.sha256(" ".join(u1_force.NVCC_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return u1_force.BUILD_DIR / f"su3_link_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile csrc/su3_link.cu unless this source's build exists;
    (library path, compiler output)."""
    return u1_force.build(verbose, SOURCE, library_path())


def _load() -> None:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    strides = ctypes.POINTER(ll)
    head = [p, strides, p, strides, p, p, ll]
    for dtype, sfx in _SUFFIX.items():
        for name, extra in ((EXPM, [i, i]), (REUNIT, [])):
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = head + extra + [i, p]
            fn.restype = i
            _LIB[name, dtype] = fn
    lib.su3_link_error_string.argtypes = [i]
    lib.su3_link_error_string.restype = ctypes.c_char_p
    _LIB["error_string"] = lib.su3_link_error_string


def _check(name: str, re: torch.Tensor, im: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return L."""
    if re.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {re.device}")
    if re.dtype not in _SUFFIX:
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
    if not _LIB:
        _load()
    sr = (ctypes.c_longlong * 3)(*re.stride())
    si = (ctypes.c_longlong * 3)(*im.stride())
    rc = _LIB[name, re.dtype](re.data_ptr(), sr, im.data_ptr(), si,
                              out_re.data_ptr(), out_im.data_ptr(), n,
                              *extra, re.device.index,
                              u1_force._raw_stream(re))
    if rc != 0:
        what = _LIB["error_string"](rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({what})")
    launches.add(name)
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
