"""Halo exchange: ±1 rolls across a lattice axis sharded over ranks.

PyTorch counterpart of the JAX package's `parallel/halo.py`. A lattice
axis (conventionally t) is split over the 'lattice' axis of the mesh: rank
i of the lattice group holds rows [i*L, (i+1)*L). The ±1 neighbour shifts
that the plaquette and staple sums need become a local `torch.roll` plus
one slab sent to a neighbour and one received from the other, issued
together with `dist.batch_isend_irecv` (blocking sends around a ring
would deadlock). Both ops of one roll go one way round the ring, so at a
lattice extent of 2, where both neighbours are the same rank, the one
slab sent and the one received cannot be confused.

`roll_halo` is a `torch.autograd.Function` whose backward is the opposite
roll, with its own exchange: the transpose of the exchange, which JAX
derives by itself for `ppermute`. The slabs travel on the tensors' own
device: gloo takes CPU tensors, NCCL CUDA ones.

Larger shifts compose ±1 rolls; the gauge action needs only ±1.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from l2hmc_torch.parallel.mesh import Mesh


def _exchange(x: torch.Tensor, shift: int, axis: int, mesh: Mesh
              ) -> torch.Tensor:
    """Global circular roll by shift in {-1, +1} of the lattice-sharded
    axis, without autograd."""
    n = mesh.n_lattice
    local = torch.roll(x, shift, dims=axis)
    size = x.shape[axis]
    group = mesh.lattice_group
    li = mesh.lattice_index
    base = mesh.data_index * n
    # shift -1 (out[t] = x[t+1]): every rank sends its first row to the
    # previous rank and takes the next rank's first row as its last row;
    # shift +1 the mirror image
    if shift == -1:
        send = x.narrow(axis, 0, 1)
        dst, src = base + (li - 1) % n, base + (li + 1) % n
        at = size - 1
    else:
        send = x.narrow(axis, size - 1, 1)
        dst, src = base + (li + 1) % n, base + (li - 1) % n
        at = 0
    send = send.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    mesh.counts["halo_exchange"] += 1
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(at, at + 1)
    local[tuple(idx)] = recv
    return local


class _RollHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, axis, mesh):
        ctx.shift, ctx.axis, ctx.mesh = shift, axis, mesh
        return _exchange(x, shift, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return (roll_halo(g, -ctx.shift, ctx.axis, ctx.mesh), None, None,
                None)


def roll_halo(x: torch.Tensor, shift: int, axis: int,
              mesh: Optional[Mesh]) -> torch.Tensor:
    """Circular roll by `shift` in {-1, 0, +1} along `axis`, whose global
    extent is split over the mesh's lattice group; a plain `torch.roll`
    where the lattice axis has one rank (or no mesh)."""
    if shift == 0 or mesh is None or mesh.n_lattice == 1:
        return torch.roll(x, shift, dims=axis)
    if shift not in (-1, 1):
        raise ValueError(f"halo roll takes shifts of +-1, got {shift} "
                         "(compose them for more)")
    return _RollHalo.apply(x, shift, axis, mesh)


def make_sharded_roll(mesh: Mesh, sharded_axis: int) -> Callable:
    """A `torch.roll(x, shift, axis)`-shaped roll that halo-exchanges on
    `sharded_axis` and rolls locally on every other axis."""

    def roll(x, shift, axis):
        if axis == sharded_axis:
            return roll_halo(x, shift, axis, mesh)
        return torch.roll(x, shift, dims=axis)

    return roll


def make_sharded_comp_roll(mesh: Mesh, lat_local, nb: int) -> Callable:
    """The roll of the component engine (`ops/su3_comp.make_roll`: a
    per-direction field (3, 3, V*nb) viewed as (3, 3, pre, L_axis, post))
    over LOCAL lattice extents, whose axis 0 (t) is split over the mesh's
    lattice group; it plugs into the engine's `roll=` slot."""
    lat = tuple(int(n) for n in lat_local)

    def roll(a: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
        pre = math.prod(lat[:axis])
        post = math.prod(lat[axis + 1:]) * nb
        v = a.reshape(3, 3, pre, lat[axis], post)
        if axis == 0:
            out = roll_halo(v, shift, 3, mesh)
        else:
            out = torch.roll(v, shift, dims=3)
        return out.reshape(a.shape)

    return roll
