"""Build and load the port's hand-written CUDA libraries.

Each library is one `.cu` file under `l2hmc_torch/csrc/` with a plain C
interface, compiled by nvcc into a shared object and loaded with ctypes.
A wrapper module declares its library once, at import, with the leading
argument types of each kernel's entry point:

    LIB = Library(SOURCE, {"u1_force_fwd": [p, p, p, p, i, i, i], ...})

and launches with `LIB.launch(name, like, *args)`. Nothing is built or
loaded on import: the first launch builds the library (unless its build
exists) and loads it, once per process.

The C interface every library keeps: for each kernel `<name>` the entry
points `<name>_f32` and `<name>_f64`, which take the declared arguments,
then the device's index (int) and a CUDA stream, and return a CUDA error
code (0 on success); and `<stem>_error_string(int)`, the text of a code,
`<stem>` the source's file name without `.cu`.

A library's build is keyed by a hash of the compiler flags, its source
and the local headers the source includes (`#include "..."`, followed
recursively), so a stale build is never loaded and editing one library's
source rebuilds that library only. Builds go to
`build/l2hmc_torch_kernels/` of the checkout that holds the source
(listed in .gitignore), through a temporary file renamed into place, so
concurrent builds agree; the compiler's output goes beside each build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from l2hmc_torch.ops.kernels import launches

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
#: the dtypes each entry point comes in, by the suffix of its name
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def nvcc() -> str:
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


def build_inputs(source: Path) -> list[Path]:
    """Every file a build of `source` reads: the source, then the local
    headers it includes, each relative to the file that includes it."""
    found = [Path(source)]
    for f in found:          # grows as headers are found
        for name in _LOCAL_INCLUDE.findall(f.read_text()):
            header = Path(os.path.normpath(f.parent / name))
            if header not in found:
                found.append(header)
    return found


def raw_stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the integer handle (no
    Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def beta(value, like: torch.Tensor):
    """beta as every kernel takes it: a non-trainable scalar of one value,
    a number or a tensor on like's device or the CPU. A tensor on like's
    device comes back as a contiguous 0-d tensor of like's dtype (cast
    where its dtype differs), never read on the host; anything else as a
    Python float."""
    if isinstance(value, torch.Tensor):
        if value.requires_grad:
            raise ValueError(
                "beta is a non-trainable scalar here: the kernels return "
                "no gradient for it")
        if value.numel() != 1:
            raise ValueError(f"beta must be one value, got shape "
                             f"{tuple(value.shape)}")
        if value.device == like.device:
            return value.reshape(()).to(like.dtype).contiguous()
        if value.device.type != "cpu":
            raise ValueError(f"beta is on {value.device}, the kernel's "
                             f"tensors on {like.device}")
    return float(value)


class Library:
    """One CUDA library: its source, the leading argument types of its
    kernels' entry points by kernel name, and, once loaded, the entry
    points by (name, dtype). Each name is registered in
    `ops/kernels/launches.py` and counted there once per launch."""

    def __init__(self, source: Path, entries: dict):
        self.source = Path(source)
        self.entries = entries
        self._fns: dict = {}
        self._error_string = None
        launches.register(*self.entries)

    def path(self) -> Path:
        """The shared object for the current flags, source and headers."""
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in build_inputs(self.source):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return (self.source.parents[2] / "build" / "l2hmc_torch_kernels"
                / f"{self.source.stem}_{h.hexdigest()[:16]}.so")

    def build(self) -> tuple[Path, str]:
        """Compile the source unless its build exists. Returns (library
        path, compiler output). The compiler runs with -Xptxas -v
        (registers, shared memory, spills per kernel), and its output is
        kept beside the library, so a build that exists reports it too
        (empty where it was built without)."""
        path = self.path()
        log = path.with_suffix(".txt")
        if path.exists():
            return path, log.read_text() if log.exists() else ""
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               str(self.source)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                    f"{r.stdout}{r.stderr}")
            out = r.stdout + r.stderr
            fd, tmp_log = tempfile.mkstemp(suffix=".txt", dir=path.parent)
            with os.fdopen(fd, "w") as f:
                f.write(out)
            os.replace(tmp_log, log)
            os.replace(tmp, path)     # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path, out

    def load(self) -> ctypes.CDLL:
        """Build if needed, load the library and resolve its entry points
        (once per process); the loaded library."""
        path, _ = self.build()
        lib = ctypes.CDLL(str(path))
        if not self._fns:
            for name, head in self.entries.items():
                for dtype, sfx in SUFFIX.items():
                    fn = getattr(lib, f"{name}_{sfx}")
                    fn.argtypes = [*head, ctypes.c_int, ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    self._fns[name, dtype] = fn
            err = getattr(lib, f"{self.source.stem}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self._error_string = err
        return lib

    def entry(self, name: str, dtype: torch.dtype):
        """The entry point of kernel `name` for dtype."""
        if not self._fns:
            self.load()
        return self._fns[name, dtype]

    def launch(self, name: str, like: torch.Tensor, *args) -> None:
        """Launch kernel `name` for like's dtype with `args`, on like's
        device and PyTorch's current stream there, and count the launch.
        A failed launch raises RuntimeError with the library's text for
        its error code."""
        rc = self.entry(name, like.dtype)(*args, like.device.index,
                                          raw_stream(like))
        if rc != 0:
            what = self._error_string(rc).decode()
            raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                               f"({what})")
        launches.add(name)
