"""Lattice-domain-decomposed SU(3): action, force, plaquettes, Wilson flow
and HMC over a (data, lattice) mesh of ranks.

PyTorch counterpart of the JAX package's `parallel/lattice_sharded.py`.
The chains split over the mesh's 'data' axis and the lattice t axis over
its 'lattice' axis. A rank holds its block of the complex field,
(nb / n_data, 4, T / n_lattice, X, Y, Z, 3, 3), and runs the port's
component engine (`ops/su3_comp`) on it with the halo-exchange roll
(`parallel/halo.make_sharded_comp_roll`) in the engine's `roll=` slot, for
the Wilson (c1 = 0) and the improved (c1 != 0) action alike. Every
per-chain sum over sites (action, kinetic energy, plaquette traces, the
clover charge, dH) is a local sum plus an all-reduce over the lattice
group: the Hamiltonian is a sum over sites, so dH of the whole lattice is
the sum of the blocks' dH.

The JAX package runs its c1 = 0 branch in a structure-of-arrays layout
made for TPU vector tiles; the port has no such layout, and this module
is held to the same numbers through the engine.

Random draws (momenta, MH uniforms, Haar links) are made at the global
shape from the caller's generator and sliced to the block, so a sharded
run draws what one device draws.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from l2hmc_torch.ops import su3 as g
from l2hmc_torch.ops import su3_comp as comp
from l2hmc_torch.ops import wilson_flow as wf
from l2hmc_torch.parallel.halo import make_sharded_comp_roll
from l2hmc_torch.parallel.mesh import Mesh
from l2hmc_torch.utils import mh

#: the t axis of the complex field (nb, 4, t, x, y, z, 3, 3)
T_AXIS = 2


class ShardedLatticeSU3:
    """Sharded counterpart of `ops/lattice_su3.LatticeSU3`. Methods take
    and return this rank's block; per-chain results cover the whole
    lattice and this rank's chains."""

    def __init__(self, mesh: Mesh, nchains: int, shape, c1: float = 0.0):
        if len(shape) != 4:
            raise ValueError(f"SU(3) lattice shape must be 4D, got {shape}")
        self.mesh = mesh
        self.latvolume = tuple(int(s) for s in shape)
        self.volume = math.prod(self.latvolume)
        self.c1 = float(c1)
        self.nchains = int(nchains)
        self.n_data, self.n_lattice = mesh.n_data, mesh.n_lattice
        if self.latvolume[0] % self.n_lattice:
            raise ValueError(
                f"lattice t extent {self.latvolume[0]} must divide the "
                f"'lattice' mesh axis ({self.n_lattice})")
        if self.nchains % self.n_data:
            raise ValueError(
                f"nchains {self.nchains} must divide the 'data' mesh axis "
                f"({self.n_data})")
        self.local_volume = (self.latvolume[0] // self.n_lattice,
                             *self.latvolume[1:])
        self.nb_local = self.nchains // self.n_data
        self.xshape = (self.nchains, 4, *self.latvolume, 3, 3)
        self.roll = make_sharded_comp_roll(mesh, self.local_volume,
                                           self.nb_local)

    # -- blocks ------------------------------------------------------------
    def shard(self, x: torch.Tensor, chain_dim: int = 0,
              t_dim: int = T_AXIS) -> torch.Tensor:
        """This rank's block of a global (nb, 4, T, ...) tensor."""
        return self.mesh.block(self.mesh.block(x, "data", chain_dim),
                               "lattice", t_dim)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block."""
        return self.mesh.gather(self.mesh.gather(x, "lattice", T_AXIS),
                                "data", 0)

    def lattice_sum(self, t: torch.Tensor, autograd: bool = False):
        return self.mesh.all_reduce(t, "lattice", autograd=autograd)

    # -- draws at the global shape -----------------------------------------
    def random_x(self, generator=None, dtype=torch.complex128, device=None):
        """Haar links, as `ops/su3.random` draws them for the whole field."""
        rdt = g.real_dtype(dtype)
        draws = tuple(self.shard(torch.randn(self.xshape, generator=generator,
                                             dtype=rdt, device=device))
                      for _ in range(2))
        return g.random(draws[0].shape, dtype=dtype, draws=draws)

    def random_v(self, generator=None, dtype=torch.complex128, device=None):
        """TAH momenta, as `ops/su3.random_momentum` draws them."""
        base = self.xshape[:-2]
        normals = torch.randn((8, *base), generator=generator,
                              dtype=g.real_dtype(dtype), device=device)
        local = self.shard(normals, chain_dim=1, t_dim=T_AXIS + 1)
        return g.random_momentum((*local.shape[1:], 3, 3), dtype=dtype,
                                 draws=local)

    def random_u(self, generator=None, dtype=torch.float64, device=None):
        """MH uniforms, one per chain."""
        u = torch.rand((self.nchains,), generator=generator, dtype=dtype,
                       device=device)
        return self.mesh.shard_chains(u)

    # -- physics -------------------------------------------------------------
    def _engine(self, x: torch.Tensor) -> comp.F3:
        return comp.from_complex_lattice(x)

    def _complex(self, f: comp.F3, dtype) -> torch.Tensor:
        return comp.to_complex_lattice(f, self.local_volume, self.nb_local,
                                       dtype)

    def action(self, x, beta):
        s = comp.action(self._engine(x), beta, self.local_volume,
                        self.nb_local, roll=self.roll, c1=self.c1)
        return self.lattice_sum(s)

    def grad_action(self, x, beta):
        f = comp.grad_action(self._engine(x), beta, self.local_volume,
                             self.nb_local, roll=self.roll, c1=self.c1)
        return self._complex(f, x.dtype)

    def kinetic_energy(self, v):
        return self.lattice_sum(comp.kinetic_energy(self._engine(v),
                                                    self.nb_local))

    def plaq_sums(self, x) -> torch.Tensor:
        """Per-chain plaquette Re-trace sums over the whole lattice."""
        re_tot, _ = comp.plaq_traces(self._engine(x), self.local_volume,
                                     self.nb_local, roll=self.roll)
        return self.lattice_sum(re_tot.reshape(-1, self.nb_local).sum(0))

    def plaqs(self, x):
        return self.plaq_sums(x) / (6 * 3 * self.volume)

    def flow(self, x, eps: float, nsteps: int):
        """Wilson-flow the block (ops/wilson_flow RK3 over the halo roll);
        returns (flowed block, {'t', 'plaq', 't2E', 'Qclover'}) with the
        observables summed over the lattice group."""
        lat, nb = self.local_volume, self.nb_local
        res = wf.flow(self._engine(x), eps, nsteps, lat, nb, roll=self.roll)
        q = comp.topo_charge_clover(res.x, lat, nb, roll=self.roll)
        # one reduction for both: (nsteps + 1, nb)
        tot = self.lattice_sum(torch.cat([res.tr, q[None]], dim=0))
        obs = wf.flow_observables(res.t, tot[:-1], self.volume)
        obs["Qclover"] = tot[-1]
        return self._complex(res.x, x.dtype), obs

    def hmc_trajectory(self, x, v, beta, eps, nlf: int, with_traces=False):
        """nlf leapfrog steps; returns (x', v', dH = H0 - H1), and with
        with_traces the per-chain plaquette Re-trace sums of x and x'."""
        xp, vp, dh, (tr0, tr1) = comp.hmc_trajectory(
            self._engine(x), self._engine(v), beta, eps, nlf,
            self.local_volume, self.nb_local, roll=self.roll, c1=self.c1,
            with_traces=True)
        dh, tr0, tr1 = self.lattice_sum(torch.stack([dh, tr0, tr1]))
        out = (self._complex(xp, x.dtype), self._complex(vp, v.dtype), dh)
        return out + ((tr0, tr1),) if with_traces else out

    def hmc_step(self, x, beta, generator=None, eps=0.1, nlf: int = 1,
                 v: Optional[torch.Tensor] = None,
                 u: Optional[torch.Tensor] = None):
        """Momentum refresh, trajectory and Metropolis test on the mesh;
        v and u (this rank's blocks) replace the global draws."""
        rdt = g.real_dtype(x.dtype)
        if v is None:
            v = self.random_v(generator, x.dtype, x.device)
        xp, vp, dh, (tr0, tr1) = self.hmc_trajectory(x, v, beta, eps, nlf,
                                                     with_traces=True)
        acc = mh.accept_prob(dh).to(rdt)
        if u is None:
            u = self.random_u(generator, rdt, x.device)
        mask = (acc > u).to(rdt)
        norm = 6.0 * 3.0 * self.volume
        return mh.select(mask, xp, x), {
            "acc": acc, "acc_mask": mask, "dh": dh, "plaqs": tr0 / norm,
            "plaqs_out": mask * tr1 / norm + (1.0 - mask) * tr0 / norm}
