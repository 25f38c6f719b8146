"""The port's parallel/ over torch.distributed, on the CPU: 2 and 4 gloo
processes, spawned per group of checks (tests/torch_dist_workers.py),
rendezvous through a file under the test's tmp_path (no TCP port to race
for between xdist workers), one torch thread each, one spawn per world
size (a spawn costs a few seconds of process start-up). Every check holds the
distributed path against the port's single-device path at float64 (which
the other test_torch_* files hold against the JAX package): the halo roll
and its gradient, the 1-D data-parallel U(1) train step with and without
BN and dropout (loss rtol 1e-10, x and parameters atol 1e-10),
ShardedLatticeSU3 at (1, 2) and (2, 2) to 1e-12, ShardedTrainerSU3 at
(2, 2) and (1, 4), and a 2-rank Experiment with kill-and-resume. The
(2, 2) action and force are also held against the JAX package's engine
on the same field (rtol 1e-12, atol 1e-10, as tests/test_torch_su3_comp.py
holds the engines); tests/test_torch_su3_trainer.py holds a (2, 2)
train step against the JAX Trainer's."""
import jax
import numpy as np
import pytest
import torch

from l2hmc_torch.ops import su3_comp as tc
from l2hmc_tpu.ops import su3_comp as jc
from torch_dist_workers import spawn
from torch_parity import comp_np, eager  # noqa: F401

torch.set_num_threads(1)


def test_two_ranks(tmp_path):
    """The halo roll, the data-parallel U(1) step, ShardedLatticeSU3 at
    (1, 2), and the 2-rank Experiment with kill-and-resume."""
    spawn(str(tmp_path), 2, "two_ranks", tmp=str(tmp_path))


def test_four_ranks(tmp_path, eager):
    """ShardedLatticeSU3 and ShardedTrainerSU3 at (2, 2), and
    ShardedTrainerSU3 on the lattice-only mesh (1, 4); the gathered (2, 2)
    action and force against the JAX package's engine."""
    spawn(str(tmp_path), 4, "four_ranks", tmp=str(tmp_path))
    got = torch.load(tmp_path / "lattice.pt")
    lat, nb, beta = got["lattice"], got["nchains"], got["beta"]
    jx = jc.from_complex_lattice(jax.numpy.asarray(got["x"].numpy()))
    np.testing.assert_allclose(got["action"].numpy(),
                               np.asarray(jc.action(jx, beta, lat, nb)),
                               rtol=1e-12, atol=0)
    jf = jc.grad_action(jx, beta, lat, nb)
    for a, b in zip(comp_np(tc.from_complex_lattice(got["force"])),
                    comp_np(jf)):
        np.testing.assert_allclose(a, b, atol=1e-10, rtol=0)


def test_single_process_mesh_and_setup(monkeypatch):
    """One process: setup_distributed is a no-op returning 0, a
    half-configured environment raises, a (1, 1) mesh has no-op
    collectives, and a mesh that wants more processes raises."""
    from l2hmc_torch.parallel import mesh as pmesh
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.setup_distributed("cpu") == 0
    assert pmesh.setup_distributed("cpu") == 0
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="half-configured"):
        pmesh.setup_distributed("cpu")
    monkeypatch.delenv("WORLD_SIZE")
    m = pmesh.Mesh(1, 1)
    t = torch.arange(4.0)
    assert m.all_reduce(t.clone(), "data") is not None
    assert torch.equal(m.gather(t), t) and not m.counts
    assert torch.equal(m.shard_chains(t), t)
    with pytest.raises(ValueError, match="needs 2 processes"):
        pmesh.Mesh(2, 1)
    # Experiment joins the process group before it builds anything
    # (tests/test_experiment.py's bootstrap check)
    from l2hmc_torch.experiment import build_experiment
    calls = []
    real = pmesh.setup_distributed
    monkeypatch.setattr(pmesh, "setup_distributed",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    ex = build_experiment(["dynamics.nchains=4", "dynamics.latvolume=[4, 4]",
                           "dynamics.nleapfrog=1", "network.units=[4]",
                           "save=false"], device="cpu")
    assert calls and ex.rank == 0 and ex.is_main and ex.mesh is None
