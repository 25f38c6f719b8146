"""Worker side of the port's multi-process tests
(tests/test_torch_parallel.py).

Each check runs in every one of N processes spawned by the test, joined
into one gloo process group through a file:// rendezvous, one torch
thread each. A check holds the distributed path against the port's
single-device path, computed in the same process from the same weights
and the same (global) draws, and raises on a mismatch; the test sees the
traceback. Where the test holds the distributed path against the JAX
package itself, rank 0 saves what it gathered to a file the test reads.
Only torch and l2hmc_torch are imported here.
"""
from __future__ import annotations

import os

import torch

TOL = 1e-10


def spawn(workdir: str, world: int, name: str, **kwargs) -> None:
    """Runs the check `name(**kwargs)` in `world` processes; the
    rendezvous file lives in the test's own directory `workdir`."""
    import torch.multiprocessing as mp
    mp.spawn(run, args=(world, os.path.join(workdir, "rendezvous"), name,
                        kwargs), nprocs=world, join=True)


def run(rank: int, world: int, init_file: str, name: str, kwargs: dict):
    torch.set_num_threads(1)
    from l2hmc_torch.parallel import mesh as pmesh
    assert pmesh.setup_distributed(
        "cpu", init_method=f"file://{init_file}", rank=rank,
        world_size=world) == rank
    try:
        globals()[name](**kwargs)
    finally:
        pmesh.teardown_distributed()


def close(a, b, atol=TOL, what="", rtol=0.0):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = (a - b).abs() - rtol * b.abs()
    err = float(bad.max()) if a.numel() else 0.0
    assert err <= atol, f"{what}: max err {err} > {atol} (rtol {rtol})"


def close_modules(m1, m2, atol=TOL):
    s1, s2 = m1.state_dict(), m2.state_dict()
    assert s1.keys() == s2.keys()
    for k in s1:
        close(s2[k], s1[k], atol, k)


def _cfg(overrides, group="U1"):
    from l2hmc_torch.configs import get_config
    return get_config(list(overrides), group=group)


def _trainers(overrides, mesh_shape, group):
    from l2hmc_torch.parallel.mesh import Mesh
    from l2hmc_torch.train.trainer import Trainer
    one = Trainer(_cfg(overrides, group), device="cpu")
    many = Trainer(_cfg(overrides, group), device="cpu",
                   mesh=Mesh(*mesh_shape))
    return one, many


# ---------------------------------------------------------------------------
# Checks shared by several meshes
# ---------------------------------------------------------------------------
def steps_in_sync(one, many, x, beta, draws, nsync=3, atol=TOL):
    """One injected train step, then `nsync` train steps and an eval and
    an HMC step drawing from generators seeded alike: the mesh equals one
    device in the loss, x, every parameter and buffer and the metrics.
    Every rank runs the mesh's steps; the single-device reference runs on
    rank 0 alone, which compares (the other ranks would only repeat it).
    Returns the injected step's metrics (one device, the mesh) on rank 0,
    None elsewhere."""
    ref = many.mesh.rank == 0
    x2, m2 = many.train_step(many.shard(x), beta, draws=draws)
    xg = many.gather(x2)
    first = None
    if ref:
        x1, m1 = one.train_step(x, beta, draws=draws)
        close(m2["loss"], m1["loss"], atol, "loss", rtol=atol)
        close(xg, x1, atol, "x")
        close_modules(one.dynamics, many.dynamics, atol)
        for k in ("acc", "acc_mask", "sumlogdet", "plaqs", "dQint",
                  "grad_norm", "grad_nonfinite"):
            close(m2[k], m1[k], atol, k)
        first = (m1, m2)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    for _ in range(nsync):
        x2, m2 = many.train_step(x2, beta, g2)
        if ref:
            x1, m1 = one.train_step(x1, beta, g1)
    xg = many.gather(x2)
    if ref:
        close(xg, x1, 10 * atol, "x after steps")
        close_modules(one.dynamics, many.dynamics, 10 * atol)
    for step in ("eval_step", "hmc_step"):
        args = (beta, 0.1) if step == "hmc_step" else (beta,)
        x2, m2 = getattr(many, step)(x2, *args, generator=g2)
        xg = many.gather(x2)
        if ref:
            x1, m1 = getattr(one, step)(x1, *args, generator=g1)
            close(xg, x1, 10 * atol, step)
            for k in m1:
                close(m2[k], m1[k], 10 * atol, f"{step} {k}")
    return first


def lattice_checks(mesh, c1, dump=None):
    """ShardedLatticeSU3 against the engine on the whole lattice: action and
    kinetic energy (sums over ~10^3 terms) to rtol 1e-12, force,
    plaquettes, an HMC trajectory and the flow observables with the clover
    charge to 1e-12, dH (a difference of two such sums) and an HMC step
    to 1e-10. Every rank runs the sharded calls and gathers; rank 0
    computes the reference and compares, and saves x and the gathered
    action and force to `dump` where one is given."""
    from l2hmc_torch.ops import su3 as g
    from l2hmc_torch.ops import su3_comp as comp
    from l2hmc_torch.ops import wilson_flow as wf
    from l2hmc_torch.parallel.lattice_sharded import ShardedLatticeSU3
    lat, nb, beta = (4, 2, 2, 2), 4, 5.7
    gen = torch.Generator().manual_seed(0)
    x = comp.to_complex_lattice(comp.reunit(comp.from_complex_lattice(
        g.random((nb, 4, *lat, 3, 3), gen))), lat, nb, torch.complex128)
    v = g.random_momentum(x.shape, gen)
    sl = ShardedLatticeSU3(mesh, nb, lat, c1=c1)
    xl, vl = sl.shard(x), sl.shard(v)

    def chains(t, dim=0):
        return mesh.gather(t, "data", dim)

    got = {"action": chains(sl.action(xl, beta)),
           "force": sl.gather(sl.grad_action(xl, beta)),
           "kinetic": chains(sl.kinetic_energy(vl)),
           "plaqs": chains(sl.plaqs(xl))}
    sx, sv, sdh = sl.hmc_trajectory(xl, vl, beta, 0.05, 3)
    got.update(hmc_x=sl.gather(sx), hmc_v=sl.gather(sv), dh=chains(sdh))
    # a full HMC step draws v, then u, at the global shape
    _, ms = sl.hmc_step(xl, beta, torch.Generator().manual_seed(3), 0.05, 3)
    got.update(step_dh=chains(ms["dh"]), step_mask=chains(ms["acc_mask"]))
    fx, fobs = sl.flow(xl, 0.05, 2)
    got.update(flow_x=sl.gather(fx), Qclover=chains(fobs["Qclover"]),
               t=fobs["t"], plaq=chains(fobs["plaq"], 1),
               t2E=chains(fobs["t2E"], 1))
    if mesh.rank != 0:
        return
    if dump:
        torch.save({"x": x, "beta": beta, "lattice": lat, "nchains": nb,
                    "action": got["action"], "force": got["force"]}, dump)
    xc, vc = comp.from_complex_lattice(x), comp.from_complex_lattice(v)
    tol = 1e-12

    def cplx(f):
        return comp.to_complex_lattice(f, lat, nb, x.dtype)

    close(got["action"], comp.action(xc, beta, lat, nb, c1=c1), 0, "action",
          rtol=tol)
    close(got["force"], cplx(comp.grad_action(xc, beta, lat, nb, c1=c1)),
          tol, "force")
    close(got["kinetic"], comp.kinetic_energy(vc, nb), 0, "kinetic",
          rtol=tol)
    re, _ = comp.plaq_traces(xc, lat, nb)
    close(got["plaqs"], re.reshape(-1, nb).sum(0) / (18 * 32), tol, "plaqs")
    xp, vp, dh = comp.hmc_trajectory(xc, vc, beta, 0.05, 3, lat, nb, c1=c1)
    close(got["hmc_x"], cplx(xp), tol, "hmc x")
    close(got["hmc_v"], cplx(vp), tol, "hmc v")
    close(got["dh"], dh, 1e-10, "dH")
    g1 = torch.Generator().manual_seed(3)
    v1 = g.random_momentum(x.shape, g1)
    u1 = torch.rand((nb,), generator=g1, dtype=torch.float64)
    _, _, dh1 = comp.hmc_trajectory(xc, comp.from_complex_lattice(v1), beta,
                                    0.05, 3, lat, nb, c1=c1)
    close(got["step_dh"], dh1, 1e-10, "hmc_step dH")
    close(got["step_mask"], (torch.exp(dh1.clamp(max=0)) > u1).double(), 0,
          "hmc_step accept")
    res = wf.flow(xc, 0.05, 2, lat, nb)
    obs = wf.flow_observables(res.t, res.tr, 32)
    close(got["flow_x"], cplx(res.x), tol, "flowed x")
    close(got["Qclover"], comp.topo_charge_clover(res.x, lat, nb), tol,
          "Qclover")
    for k in ("t", "plaq", "t2E"):
        close(got[k], obs[k], tol, k)


SU3 = ["dynamics.nchains=4", "dynamics.latvolume=[4, 2, 2, 2]",
       "dynamics.nleapfrog=1", "dynamics.eps=0.1", "network.units=[4]",
       "network.use_batch_norm=false", "network.dropout_prob=0.0",
       "precision=float64", "loss.charge_weight=0.01",
       "loss.plaq_weight=0.1", "loss.rmse_weight=0.1",
       "learning_rate.clip_norm=1.0", "seed=3"]


def sharded_trainer_checks(mesh_shape):
    """ShardedTrainerSU3 (through the Trainer) against one device: train
    step, eval and HMC steps, steps in sync; the c1 != 0 action; the
    verbose series; the refusals."""
    from l2hmc_torch.ops import su3 as g
    from l2hmc_torch.parallel.mesh import Mesh
    from l2hmc_torch.train.trainer import Trainer
    for extra in ([], ["c1=-0.331", "dynamics.verbose=true"]):
        one, many = _trainers(SU3 + extra, mesh_shape, "SU3")
        assert many.sharded is not None
        gen = torch.Generator().manual_seed(1)
        x = one.dynamics.random_x(gen)
        draws = {"v": g.random_momentum(x.shape, gen),
                 "u": torch.rand((4,), generator=gen, dtype=torch.float64)}
        first = steps_in_sync(one, many, x, 5.7, draws,
                              nsync=3 if not extra else 1)
        if extra and first is not None:
            m1, m2 = first
            for k in ("energy", "logdet", "logprob"):
                close(m2[k], m1[k], 1e-9, k)
    mesh = Mesh(*mesh_shape)
    for bad, match in [(["network.use_batch_norm=true"], "BN"),
                       (["network.dropout_prob=0.1"], "dropout"),
                       (["loss.charge_flow_nsteps=1"], "flowed"),
                       (["dynamics.latvolume=[3, 2, 2, 2]"], "t extent"),
                       (["dynamics.nchains=3"], "nchains")]:
        if match == "nchains" and mesh.n_data == 1:
            continue
        try:
            Trainer(_cfg(SU3 + bad, "SU3"), "cpu", mesh)
        except ValueError as e:
            assert match in str(e), (match, e)
        else:
            raise AssertionError(f"no ValueError for {bad}")
    try:
        _trainers(["dynamics.nchains=4", "dynamics.latvolume=[4, 4]"],
                  mesh_shape, "U1")
    except ValueError as e:
        assert "SU(3) feature" in str(e)
    else:
        raise AssertionError("U(1) on a 2-D mesh did not raise")


# ---------------------------------------------------------------------------
# The spawned groups of checks
# ---------------------------------------------------------------------------
U1 = ["dynamics.nchains=8", "dynamics.latvolume=[4, 4]",
      "dynamics.nleapfrog=2", "network.units=[8, 8]", "precision=float64",
      "learning_rate.clip_norm=1.0", "seed=2"]


def halo_and_data_parallel():
    """World 2: the mesh's errors, the halo roll (values and gradcheck),
    the 1-D data-parallel U(1) step with BN off and with BN and dropout
    on, and ShardedLatticeSU3 at (1, 2)."""
    from l2hmc_torch.parallel import mesh as pmesh
    from l2hmc_torch.parallel.halo import make_sharded_roll, roll_halo
    assert pmesh.setup_distributed() == pmesh.rank()     # idempotent
    try:
        pmesh.Mesh(1, 1)
    except ValueError as e:
        assert "needs 1 processes" in str(e)
    else:
        raise AssertionError("a (1, 1) mesh over 2 processes did not raise")
    mesh = pmesh.Mesh(1, 2)
    a = torch.randn((3, 2, 8, 5), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    roll = make_sharded_roll(mesh, 2)
    for shift in (-1, 1):
        close(roll(mesh.block(a, "lattice", 2), shift, 2),
              mesh.block(torch.roll(a, shift, 2), "lattice", 2), 0, "halo")
        close(roll(mesh.block(a, "lattice", 2), shift, 0),
              mesh.block(torch.roll(a, shift, 0), "lattice", 2), 0, "local")
        small = mesh.block(a[:1, :1, :, :2], "lattice", 2).clone()
        assert torch.autograd.gradcheck(
            lambda t: roll_halo(t, shift, 2, mesh),
            (small.requires_grad_(),))
    for bn in (False, True):
        extra = (["network.use_batch_norm=true", "network.dropout_prob=0.2"]
                 if bn else ["network.use_batch_norm=false",
                             "network.dropout_prob=0.0"])
        one, many = _trainers(U1 + extra, (2, 1), "U1")
        gen = torch.Generator().manual_seed(1)
        x = one.dynamics.random_x(gen)
        draws = {"v": torch.randn(x.shape, generator=gen,
                                  dtype=torch.float64),
                 "u": torch.rand((8,), generator=gen, dtype=torch.float64)}
        if bn:
            draws["dropout_masks"] = one.dynamics.random_dropout_masks(8, gen)
        steps_in_sync(one, many, x, 2.0, draws)
        assert many.mesh.counts["all_reduce"] > 0
    lattice_checks(mesh, 0.0)
    lattice_checks(mesh, -0.331)


def four_ranks(tmp: str):
    """World 4: ShardedLatticeSU3 and ShardedTrainerSU3 at (2, 2), and
    ShardedTrainerSU3 on the lattice-only mesh (1, 4), one t row a
    rank. Rank 0 saves the (2, 2) action and force to tmp."""
    from l2hmc_torch.parallel.mesh import Mesh
    lattice_checks(Mesh(2, 2), 0.0, dump=os.path.join(tmp, "lattice.pt"))
    sharded_trainer_checks((2, 2))
    sharded_trainer_checks((1, 4))


def two_ranks(tmp: str):
    """World 2: halo_and_data_parallel, then experiment_end_to_end."""
    halo_and_data_parallel()
    experiment_end_to_end(tmp)


def experiment_end_to_end(tmp: str):
    """World 2: Experiment on a data mesh: rank 0 alone writes; a run
    killed after one era and resumed in a fresh Experiment equals the
    uninterrupted one bit for bit; the 2-D SU(3) Experiment runs."""
    import math

    from l2hmc_torch.experiment import build_experiment
    from l2hmc_torch.parallel import mesh as pmesh
    rank = pmesh.rank()
    base = ["dynamics.nchains=8", "dynamics.latvolume=[4, 4]",
            "dynamics.nleapfrog=1", "network.units=[4]",
            "network.dropout_prob=0.2", "steps.nera=2", "steps.nepoch=2",
            "steps.test=2", "steps.log=1", "learning_rate.factor=0.5",
            "learning_rate.patience=1", "steps.warmup=2", "seed=11",
            "save=true"]
    def pipeline(ex):
        """Experiment.run without its plots (matplotlib dominates here)."""
        ex.train()
        for job in ("eval", "hmc"):
            ex.evaluate(job)
            stats = ex.sampler_stats(job)
            assert all(math.isfinite(v) for v in stats.values()), stats
        return ex.measure_improvement()

    own = os.path.join(tmp, f"own{rank}")
    ex = build_experiment(base + [f"outdir={own}"], device="cpu")
    assert ex.mesh.shape == (2, 1)
    assert math.isfinite(pipeline(ex))
    for name in ("train_history.npz", "eval_history.npz",
                 "model_improvement.txt", "checkpoints"):
        assert os.path.exists(os.path.join(own, name)) == (rank == 0), name
    assert os.path.exists(own) == (rank == 0)

    def build(sub, extra=()):
        return build_experiment(base + [f"outdir={os.path.join(tmp, sub)}",
                                        *extra], device="cpu")
    ex_a = build("a")
    ex_a.train()
    ex_b1 = build("b")
    ex_b1.train(max_eras=1)
    del ex_b1
    ex_b2 = build("b", ["restore=true"])
    ex_b2.train()
    assert ex_b2._start_era == 1
    ta, tb = ex_a.trainer, ex_b2.trainer
    assert ta.step == tb.step == 4
    close(ta.gather(ex_a._x), tb.gather(ex_b2._x), 0, "x")
    close_modules(ta.dynamics, tb.dynamics, 0)
    assert torch.equal(ex_a.generator.get_state(),
                       ex_b2.generator.get_state())
    assert ta.controller_state() == tb.controller_state()

    su3 = ["dynamics.nchains=2", "dynamics.latvolume=[2, 2, 2, 2]",
           "dynamics.nleapfrog=1", "network.units=[4]",
           "network.use_batch_norm=false", "network.dropout_prob=0.0",
           "mesh_shape=[1, 2]", "steps.nera=1", "steps.nepoch=2",
           "steps.test=2", "steps.warmup=2", "flow_nsteps=1", "save=true",
           f"outdir={os.path.join(tmp, 'su3')}"]
    ex = build_experiment(su3, group="SU3", device="cpu")
    assert ex.trainer.sharded is not None
    pipeline(ex)
    assert "flowQ_mean_abs" in ex.sampler_stats("eval")


def sharded_train_step(inputs: str, out: str, mesh_shape):
    """One train step of the Trainer on a lattice mesh from the state,
    global x and draws saved in `inputs`; rank 0 saves the loss,
    grad_norm, gathered x and per-chain metrics and the updated state to
    `out`, for the test to hold against the JAX package's step."""
    from l2hmc_torch.parallel.mesh import Mesh
    from l2hmc_torch.train.trainer import Trainer
    d = torch.load(inputs)
    tr = Trainer(_cfg(d["overrides"], "SU3"), "cpu", Mesh(*mesh_shape))
    assert tr.sharded is not None
    tr.dynamics.load_state_dict(d["state"])
    x, m = tr.train_step(tr.shard(d["x"]), d["beta"], draws=d["draws"])
    x = tr.gather(x)
    if tr.mesh.rank == 0:
        torch.save({"x": x, "state": tr.dynamics.state_dict(),
                    "metrics": {k: m[k] for k in (
                        "loss", "grad_norm", "grad_nonfinite", "acc",
                        "plaqs", "intQ", "sinQ", "dQint", "checkSU_mean",
                        "checkSU_max")}}, out)
