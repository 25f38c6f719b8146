"""Process bootstrap, the (data, lattice) process mesh, and the collectives
the port issues.

PyTorch counterpart of the JAX package's `parallel/mesh.py` (after the
reference's distributed bootstrap, src/l2hmc/utils/dist.py:197-346). One
process per device. `setup_distributed` joins the processes into one
`torch.distributed` group: NCCL between CUDA devices, gloo on the CPU.
A `Mesh` lays the ranks out as (n_data, n_lattice), rank = d * n_lattice + l,
with one process group per row and column: the chains shard over 'data',
the lattice's t axis over 'lattice'.

Every tensor a rank holds is its own block. Random draws are made at the
global shape on every rank, from generators seeded alike, and each rank
keeps its block (`shard`), so a run on several ranks draws what one device
draws. `gather` reassembles the global tensor.

Every collective goes through the mesh, which counts it in `counts`. The
sums that sit inside a differentiated computation (batch-norm statistics,
the lattice reductions of the sharded trainer) are `all_reduce(...,
autograd=True)`: its backward is the same sum over the group, so the
gradient of a loss summed over the ranks lands where it belongs.
"""
from __future__ import annotations

import collections
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
#: the group of an axis of one rank in a larger world: its collectives are
#: the identity, so no process group is made for it
_SELF = "self"


def setup_distributed(device=None, init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> int:
    """Join the process group and return this process's rank. Idempotent.

    With `init_method` (e.g. ``file:///tmp/pg``, or ``tcp://localhost:N``)
    the caller gives the rank and world size; otherwise they come from the
    environment torchrun sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
    LOCAL_RANK). With none of those variables this is a no-op that
    returns 0: one process, one device. Some of them without the others
    raise, rather than train alone in silence.

    The backend is NCCL when `device` (default: the card when CUDA is
    available) is a CUDA device, gloo otherwise. On the card each process
    takes cuda:LOCAL_RANK (or cuda:rank), which `local_device` then
    names."""
    if dist.is_initialized():
        return dist.get_rank()
    if init_method is None:
        present = [k for k in _ENV if os.environ.get(k)]
        if not present:
            return 0
        missing = [k for k in _ENV if k not in present]
        if missing:
            raise RuntimeError(
                f"half-configured distributed environment: {present} set, "
                f"{missing} missing; launch with torchrun, or unset them to "
                "run on one device")
        init_method = "env://"
    elif rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    dev = _device(device)
    kw = {} if rank is None else {"rank": int(rank),
                                  "world_size": int(world_size)}
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None else int(
            os.environ.get("LOCAL_RANK", rank if rank is not None
                           else os.environ["RANK"])))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, **kw)
    return dist.get_rank()


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def local_device(device) -> torch.device:
    """This process' own card (the one `setup_distributed` made current,
    cuda:LOCAL_RANK) for a bare "cuda"; any other device as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def teardown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward is the same sum: the adjoint of
    "every rank gets the total"."""

    @staticmethod
    def forward(ctx, t, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return mesh._all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_reduce(g.clone(), ctx.group), None, None


class Mesh:
    """(n_data, n_lattice) layout of the ranks with one process group per
    axis for this rank. Built on every rank in the same order (every rank
    creates every group, as `dist.new_group` requires). Without an
    initialized process group only the (1, 1) mesh exists, and its
    collectives are no-ops."""

    def __init__(self, n_data: int, n_lattice: int = 1):
        self.n_data, self.n_lattice = int(n_data), int(n_lattice)
        self.world = world_size()
        if self.n_data * self.n_lattice != self.world:
            raise ValueError(
                f"mesh_shape=({self.n_data}, {self.n_lattice}) needs "
                f"{self.n_data * self.n_lattice} processes but the process "
                f"group has {self.world}; launch with torchrun "
                f"--nproc_per_node {self.n_data * self.n_lattice}")
        self.rank = rank()
        self.data_index, self.lattice_index = divmod(self.rank,
                                                     self.n_lattice)
        self.counts: collections.Counter = collections.Counter()
        self.data_group = self.lattice_group = None
        self.distributed = dist.is_initialized()
        if not self.distributed:
            return
        nd, nl = self.n_data, self.n_lattice
        for li in range(nl):
            grp = self._new_group([d * nl + li for d in range(nd)])
            if li == self.lattice_index:
                self.data_group = grp
        for di in range(nd):
            grp = self._new_group([di * nl + li for li in range(nl)])
            if di == self.data_index:
                self.lattice_group = grp

    def _new_group(self, ranks: Sequence[int]):
        if len(ranks) == self.world:
            return dist.group.WORLD
        if len(ranks) == 1:
            return _SELF
        return dist.new_group(list(ranks))

    @property
    def shape(self) -> tuple:
        return (self.n_data, self.n_lattice)

    def group_of(self, axis: str):
        return self.data_group if axis == "data" else self.lattice_group

    def size_of(self, axis: str) -> int:
        return self.n_data if axis == "data" else self.n_lattice

    # -- collectives -------------------------------------------------------
    def _all_reduce(self, t: torch.Tensor, group, op=None) -> torch.Tensor:
        if self.distributed and group is not _SELF:
            self.counts["all_reduce"] += 1
            dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)
        return t

    def all_reduce(self, t: torch.Tensor, axis: str = "data",
                   autograd: bool = False, op: str = "sum") -> torch.Tensor:
        """Sum (or max) of t over one mesh axis, or over both with
        axis="world". autograd=True differentiates through the sum (sum
        only); otherwise t is reduced in place and returned."""
        group = None if axis == "world" else self.group_of(axis)
        if autograd:
            if not self.distributed or group is _SELF:
                return t
            return _AllReduceSum.apply(t, self, group)
        rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        return self._all_reduce(t, group, rop)

    def gather(self, t: torch.Tensor, axis: str = "data",
               dim: int = 0) -> torch.Tensor:
        """Concatenate every rank's t along `dim`, in the order of the
        axis' index."""
        n = self.size_of(axis)
        group = self.group_of(axis)
        if not self.distributed or group is _SELF:
            return t
        self.counts["all_gather"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    def barrier(self) -> None:
        if self.distributed:
            self.counts["barrier"] += 1
            dist.barrier()

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.distributed:
            self.counts["broadcast"] += 1
            dist.broadcast(t, src=src)
        return t

    # -- blocks of global tensors ------------------------------------------
    def block(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's block of t along `dim`, split over `axis`."""
        n = self.size_of(axis)
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"extent {size} of dim {dim} does not divide "
                             f"the '{axis}' mesh axis ({n})")
        i = self.data_index if axis == "data" else self.lattice_index
        return t.narrow(dim, i * (size // n), size // n)

    def shard_chains(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self.block(t, "data", dim)


def replicate(module: torch.nn.Module, mesh: Mesh, src: int = 0) -> None:
    """Broadcast a module's parameters and buffers from rank `src`, so
    every rank starts from the same state."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            mesh.broadcast_(t.data, src)
