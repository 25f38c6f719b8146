#!/usr/bin/env python3
"""Smoke run of the PyTorch port (l2hmc_torch) on one CUDA card.

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py graph_steps    # the build, then graph_steps alone

On the card every one-device train, eval and HMC step of the port is
replayed from a CUDA graph (`Trainer._run`); the phases below drive the
steps that way unless they say eager, which is `Trainer(graphs=False)` or
`Trainer.twin(graphs=False)`.

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from l2hmc_torch/csrc/ (nvcc, -Xptxas -v):
     the U(1) library and the SU(3) link kernels' (their registers and
     spills kept for the kernels line);
  3. hold each kernel, beta read from a device scalar, against its plain
     PyTorch version on the card, at
     the main-path shape (2048 x 2x16x16, float32 and float64), a ragged
     one (37 x 2x8x12), the 64x64 lattice, and the shapes that take the
     kernels' other paths: odd nt*nx (37 x 2x5x7, no 16-byte copies),
     32x32, one chain, more chains than one pass of the persistent grid
     holds (5000), and a view that is not 16-byte aligned; the backward
     also without gS, against the plain version with gS = 0; gradcheck
     the autograd.Function at float64;
  4. the main path: `build_experiment(...).run()` at the default U(1)
     width (2048 chains, 16x16, nleapfrog 8, units [16]*4, BatchNorm and
     dropout on) for one era of 10 train steps, then 10 eval and 10 HMC
     draws, with the kernels' launch counters set to 0 just before and
     read just after (a capture counts nothing, a replay counts its
     graph's launches); then one train, eval and HMC step each, counted
     alone against the launches expected per step;
  5. one trajectory's launches (17 forward, 17 backward) captured in a
     CUDA graph, replayed, and held bit for bit against the eager calls;
     a forward and a backward captured at beta 4 and replayed after the
     device scalar is set to 2.5, against the eager kernels (bit for bit)
     and the plain versions at 2.5;
  6. times, with CUDA events after warmup: each kernel and its plain
     version at the main-path shape, a train, an eval and an HMC step
     replayed and eager (an eager twin of the same state); the kernels'
     device time (torch.profiler), and per shape (16x16, 64x64 float32
     and float64) their event, device, graph-replay and cold-L2 times
     with bytes and bound (l2hmc_torch.utils.kernel_times); the device's
     busy share over a few train steps, replayed and eager; then
     `graph_steps` (below) on the main path's trainer;
  7. the same U(1) config with the conv front-end on its x networks
     (filters [8, 8], sizes [3, 3], pool [1, 2]), 3 train and 3 eval
     steps, the force kernels' launch counters read around it;
  8. 4D SU(3), whose engine is PyTorch on the card but for three
     hand-written kernels, the staple force and plaquette traces and the
     per-link expm and reunit, where no gradient is wanted: at float64
     on the card the engine's shared-plaquette force and action against
     the complex-matrix closed form on Haar links (4^4 x 8 chains,
     1e-10), `reunit`'s unitarity
     (1e-12) and |dH| of an HMC trajectory at eps 0.01; the force kernel
     at the draw's shape (8^4 x 8 chains, beta a device scalar) against
     its plain version in float32 (force 2e-5, traces 1e-6 a plaquette)
     and float64 (1e-12), with its event, device and graph-replay times
     beside the plain version's; the link kernels at the same shape
     against the float64 plain bodies (float32 1e-6, float64 1e-13), with
     their times, the plain bodies' times and kernel counts on the card,
     and ptxas's registers and spills; the SU(3) defaults as they stand (4^4,
     8 chains, nleapfrog 4, units [16, 16], complex128) through
     `build_experiment(...).run()` for 20 train, 10 eval and 10 HMC
     steps; the 8^4 configuration at full width (8 chains, nleapfrog 4,
     units [32, 32], float32, mixed loss on the 12-step Wilson-flowed
     clover charge, 12-step flowed eval observables, beta 5.2 -> 5.7) for
     200 warmup trajectories, 3 train, 3 eval and 3 HMC steps, each run
     with the kernels' launch counters set to 0 just before and the force
     kernel's launches required; its launches in one replayed train step
     (the first force of the transition, at least one) and one eval draw
     (all 2 nleapfrog + 1 + 3 flow steps of them), and the link kernels'
     launches in both (an eval draw: 2 nleapfrog + 3 flow steps expm,
     4 nleapfrog + flow steps reunit); the
     flowed observables replayed from their CUDA graph against the eager
     flow, bit for bit, both timed; `graph_steps` on the 4^4 default's
     and the 8^4 path's trainers; the 8^4 step times, replayed and eager,
     a profile of 2 replayed train steps (kernels per step, busy share,
     top device and host ops, peak memory), the hot ops' times beside
     their bounds with their calls per (eager) train step
     (l2hmc_torch.utils.su3_times); and `l2hmc_torch.train4dsu3.main`
     with 5 train steps;
  9. `parallel/` and `ops/su3_algebra` (the card is one, so every process
     group here has one rank; NCCL refuses two ranks on one device, and
     the multi-rank exchanges are held on the CPU over gloo by
     tests/test_torch_parallel.py): `su3_algebra` — log3x3, diffexp and
     su3_jacobian on the card against the CPU at complex128;
     `dp_u1_path` — the default U(1) width through `build_experiment` with
     a real NCCL process group of world size 1 and mesh_shape=[1, 1], 3
     train, 3 eval and 3 HMC steps, the collectives of one train step and
     the force kernels' launches counted, and one train step bit for bit
     equal to the Trainer's without a mesh from the same state and draws;
     `sharded_su3_path` — `ShardedTrainerSU3` on the (1, 1) mesh, over a
     Trainer's dynamics and optimizer update, at 8^4, 8 chains, nleapfrog
     4, units [32, 32], float32, BN and dropout off, no flowed loss: 2
     train, 1 eval and 1 HMC step, its first train step against the
     Trainer's (loss and grad_norm rtol 1e-5, parameters and x atol
     1e-5).
 10. the record drivers (l2hmc_torch/records/), full width, cut in depth:
     `run_u1_flagship.main` (2048 x 16x16, 512 eval chains) for 10 train
     steps and 10 draws under each HMC protocol, its summary's key tree
     equal to the JAX record's (records/u1_16x16_quality_summary.json)
     plus the literal protocol, `se`, `device` and `commit`, every value
     finite and 0 < acc <= 1; then the 64x64 bf16 record's configuration
     (`quality.U1_64X64_BF16`) for 3 train, 3 eval and 3 HMC steps, its
     network GEMMs in bfloat16, grad_norm finite and > 0 and no
     non-finite gradient entry on every step, its train_curve.json one
     row per train step; the force kernels must be launched in each; then
     the SU(3) 8^4 beta 5.7 record (`quality.SU3_8X8_B57`: cold start,
     12-step flowed eval) for 20 warmup trajectories, 1 train step and 2
     draws each of eval and HMC, its flowed-topology statistics finite
     and its train_curve.json carrying sumlogdet and the plaquette; then
     the same record with lr 0 (`su3_8x8_b57_frozen`) at the same depth:
     every parameter bit-equal after the train step, grad_norm finite and
     above 0, sumlogdet 0 on every chain;
 11. `Trainer.profile` for 2 replayed train steps at the default U(1)
     width: the Chrome trace it writes must hold both force kernels, 2 x
     34 forward and 2 x 17 backward launches, whose device times it
     prints.
`graph_steps`: a Trainer whose steps replay CUDA graphs and its eager
twin, from one state, through train steps across a beta and an lr change,
two windows of gradient accumulation (grad_accum_steps=2) across a beta
change, eval steps, and HMC steps across an eps change; loss, x,
parameters, buffers and Adam state held bit for bit; one graph per key
(no recapture for a new beta, eps or lr); both ways' step times, and each
graph's capture and instantiation time and pool memory.
Each result is one JSON line. The line before the last is
{"kernels": [...]} with each kernel's launches, error, times and bound
(the U(1) pair at the main path's shape, the SU(3) force, expm and
reunit at 8^4 x 8);
the last is {"ok": true, "device": {...}}.

Without CUDA, or run from a directory that holds no l2hmc_torch, it
exits non-zero before printing any result.
"""
from __future__ import annotations

import copy
import glob
import json
import math
import os
import socket
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the SU(3) 8^4 records' depth in the smoke: 20 warmup trajectories, one
#: train step, 2 flowed draws each of eval and HMC
SU3_RECORD_DEPTH = ["steps.warmup=20", "steps.nepoch=1", "steps.nera=1",
                    "steps.test=2"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def replaces(func: str, module: str = "pallas/u1_kernels.py") -> str:
    """file:line of `func` in the JAX package's ops/<module> (by default
    its TPU kernels)."""
    (path,) = [p for p in glob.glob(os.path.join(ROOT, "*", "ops",
                                                 *module.split("/")))
               if not p.startswith(os.path.join(ROOT, "l2hmc_torch"))]
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if line.startswith(f"def {func}("):
                return f"{os.path.relpath(path, ROOT)}:{n}"
    raise RuntimeError(f"{func} not found in {path}")


OFF_ALIGNMENT = "a view that is not 16-byte aligned"


def finite(v) -> bool:
    if isinstance(v, dict):
        return all(finite(x) for x in v.values())
    if isinstance(v, list):
        return all(finite(x) for x in v)
    return isinstance(v, (int, float)) and math.isfinite(v)


def u1_conv_path(torch, uk) -> None:
    """The default U(1) config with the conv front-end on the x networks:
    3 train and 3 eval steps; the force kernels must have been launched."""
    from l2hmc_torch.experiment import build_experiment
    with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
        ex = build_experiment(
            ["conv.filters=[8, 8]", "conv.sizes=[3, 3]", "conv.pool=[1, 2]",
             "steps.nera=1", "steps.nepoch=3", "steps.test=3", "save=false",
             f"outdir={out}"], device="cuda")
        assert ex.trainer.dynamics.xnets_first[0].conv is not None
        uk.reset_launch_counts()
        t0 = time.perf_counter()
        ex.train()
        ex.evaluate("eval")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = uk.launch_counts()
    hist = ex.trainer.histories["train"].get_dataset()
    stats = ex.sampler_stats("eval")
    assert finite(stats) and 0.0 < stats["acc"] <= 1.0, stats
    assert all(math.isfinite(v) for v in hist["loss"].ravel())
    assert int(hist["grad_nonfinite"].sum()) == 0
    assert launches["u1_force_fwd"] > 0 and launches["u1_force_bwd"] > 0, \
        launches
    emit({"phase": "u1_conv_path", "seconds": seconds, "launches": launches,
          "loss": [float(v) for v in hist["loss"].ravel()],
          "eval_stats": stats})


def su3_compare(torch) -> None:
    """The engine against the complex-matrix closed form, float64 on the
    card, on Haar links at 4^4 x 8 chains."""
    from l2hmc_torch.ops import lattice_su3 as lsu3
    from l2hmc_torch.ops import su3 as g
    from l2hmc_torch.ops import su3_comp as comp
    dev, lat, nb, beta = torch.device("cuda"), (4, 4, 4, 4), 8, 5.7
    gen = torch.Generator(dev).manual_seed(0)
    shape = (nb, 4, *lat, 3, 3)
    # Haar links, reunitarized: the closed-form projection of a raw
    # Gaussian draw leaves some links unitary to 1e-12 only, and the
    # shared-plaquette force is the staple force on the group alone
    xf = comp.reunit(comp.from_complex_lattice(
        g.random(shape, gen, torch.complex128, dev)))
    x = comp.to_complex_lattice(xf, lat, nb, torch.complex128)
    v = g.random_momentum(shape, gen, torch.complex128, dev)
    vf = comp.from_complex_lattice(v)
    force, tr = comp.force_and_traces(xf, beta, lat, nb)
    ref = lsu3.grad_action(x, beta, lat)
    err_force = float((comp.to_complex_lattice(force, lat, nb, x.dtype)
                       - ref).abs().max())
    act = comp.action(xf, beta, lat, nb)
    err_action = float((act - lsu3.action(x, beta, lat)).abs().max())
    err_trace = float(((-beta / 3.0) * tr - act).abs().max())
    rough = comp.add(xf, comp.scale(vf, 1e-3))
    u = comp.reunit(rough)
    uu = comp.mm(u, u, adj_a=True)
    eye = comp.eye_like(uu)
    err_unit = float(max((uu.re - eye.re).abs().max(), uu.im.abs().max()))
    _, _, dh = comp.hmc_trajectory(xf, vf, beta, 0.01, 10, lat, nb)
    torch.cuda.synchronize()
    res = {"force_max_abs_err": err_force, "action_max_abs_err": err_action,
           "trace_action_max_abs_err": err_trace,
           "reunit_unitarity": err_unit, "max_abs_dh_eps_0.01":
           float(dh.abs().max())}
    emit({"phase": "su3_compare", "dtype": "float64", "lattice": list(lat),
          "nchains": nb, **res})
    assert err_force <= 1e-10 and err_action <= 1e-10 \
        and err_trace <= 1e-10, res
    assert err_unit <= 1e-12, res
    assert res["max_abs_dh_eps_0.01"] < 0.1, res


def su3_run(torch, overrides, phase, flow: bool):
    """`build_experiment(overrides, group="SU3").run()` on the card with
    the gates of an SU(3) path, the kernels' launch counters set to 0 just
    before the run and read just after (the SU(3) force kernel must have
    been launched). Returns (the experiment, those launches)."""
    from l2hmc_torch.experiment import build_experiment
    from l2hmc_torch.ops import su3 as g
    from l2hmc_torch.ops.kernels import launches as kl
    with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
        ex = build_experiment(overrides + [f"outdir={out}"], group="SU3",
                              device="cuda")
        torch.cuda.reset_peak_memory_stats()
        kl.reset()
        t0 = time.perf_counter()
        summary = ex.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kl.counts()
    assert ex._x.is_cuda and ex._x.is_complex()
    hist = ex.trainer.histories["train"].get_dataset()
    assert finite(summary), summary
    for job in ("eval_stats", "hmc_stats"):
        assert 0.0 < summary[job]["acc"] <= 1.0, (job, summary[job])
    assert (hist["grad_norm"] > 0).all(), hist["grad_norm"]
    assert int(hist["grad_nonfinite"].sum()) == 0
    check = float(g.checkSU(ex._x)[1].max())
    assert check < 1e-3, check
    for job in ("eval", "hmc"):
        h = ex.trainer.histories[job].get_dataset()
        for key in ("flowQ", "flow_plaq", "flow_t2E"):
            assert (key in h) == flow, (job, key)
    assert launches["su3_force_fwd"] > 0, launches
    emit({"phase": phase, "seconds": seconds, "launches": launches,
          "dtype": str(ex._x.dtype).replace("torch.", ""),
          "lattice": list(ex.cfg.dynamics.latvolume),
          "nchains": ex.cfg.dynamics.nchains,
          "grad_norm": [float(v) for v in hist["grad_norm"].ravel()],
          "checkSU_max_after_training": check,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "summary": summary})
    return ex, launches


def su3_force_phase(torch, card) -> dict:
    """The SU(3) force kernel (ops/kernels/su3_force.py) at the draw's
    shape, 8^4 x 8 chains, on reunitarised Haar links, beta 5.7 from a
    device scalar, in float32 and float64: against the float64 plain
    version as tests/test_torch_su3_force_cuda.py holds it (the force to
    2e-5 in float32 and 1e-12 in float64, the trace sums to 1e-6 and
    1e-12 a plaquette); then its event, device and graph-replay times
    beside the plain version's and its bound. Returns them by dtype."""
    from l2hmc_torch.ops import su3 as g
    from l2hmc_torch.ops import su3_comp as comp
    from l2hmc_torch.ops.kernels import su3_force as sk
    from l2hmc_torch.ops.kernels import u1_force as uk
    from l2hmc_torch.utils import kernel_times as kt
    dev, lat, nb, beta = torch.device("cuda"), (8, 8, 8, 8), 8, 5.7
    gen = torch.Generator(dev).manual_seed(0)
    x64 = comp.reunit(comp.from_complex_lattice(
        g.random((nb, 4, *lat, 3, 3), gen, torch.complex128, dev)))
    want_f, want_tr = comp.force_and_traces_plain(x64, beta, lat, nb)
    plaqs = 6 * math.prod(lat)
    res = {}
    for dtype, f_tol, tr_tol in ((torch.float32, 2e-5, 1e-6),
                                 (torch.float64, 1e-12, 1e-12)):
        name = str(dtype).replace("torch.", "")
        x = comp.F3(x64.re.to(dtype).contiguous(),
                    x64.im.to(dtype).contiguous())
        bd = torch.full((), beta, dtype=dtype, device=dev)

        def kern(i=0):
            return sk.force_and_traces(x.re, x.im, bd, lat, nb)

        def plain():
            return comp.force_and_traces_plain(x, bd, lat, nb)
        f_re, f_im, tr = kern()
        torch.cuda.synchronize()
        err = max(float((f_re.double() - want_f.re).abs().max()),
                  float((f_im.double() - want_f.im).abs().max()))
        err_tr = float((tr.double() - want_tr).abs().max()) / plaqs
        plain_dev = kt.device_ms(plain, 3)
        res[name] = {
            "max_abs_err": err, "trace_err_per_plaquette": err_tr,
            "ms": kt.cuda_ms(kern, 200, batches=5),
            "plain_ms": kt.cuda_ms(plain, 20, batches=3),
            "device_ms": kt.device_ms(kern, 50)["device_ms_per_call"],
            "plain_device_ms": plain_dev["device_ms_per_call"],
            "plain_kernels_per_call": plain_dev["kernels_per_call"],
            # 36 launches a graph, as a draw's Wilson flow holds them
            "graph_replay_ms": kt.graph_replay(kern, 36, uk=uk)[0],
            **kt.su3_force_bound(lat, nb, dtype)}
        emit({"phase": "su3_force_compare", "card": card,
              "lattice": list(lat), "nchains": nb, "dtype": name,
              "beta": "device scalar", **res[name]})
        assert err <= f_tol and err_tr <= tr_tol, (name, res[name])
    return res


def su3_link_phase(torch, card, usage) -> dict:
    """The SU(3) link kernels (ops/kernels/su3_link.py) at the draw's
    shape, 8^4 x 8 chains x 4 links, in float32 and float64: `expm` at
    order 8 and two squarings of TAH momenta times 0.1 (a flow step's size
    of generator), `reunit` of Haar links 1e-4 off the group, each held to
    the float64 plain body as tests/test_torch_su3_link_cuda.py holds it
    (float32 1e-6, float64 1e-13); their event, device and graph-replay
    times beside the plain body's device time and kernel count on the
    card, the bound, and the registers and spills ptxas reported
    (`usage`). Returns them by kernel and dtype."""
    from l2hmc_torch.ops import su3 as g
    from l2hmc_torch.ops import su3_comp as comp
    from l2hmc_torch.ops.kernels import su3_link as lk
    from l2hmc_torch.ops.kernels import u1_force as uk
    from l2hmc_torch.utils import kernel_times as kt
    dev, lat, nb = torch.device("cuda"), (8, 8, 8, 8), 8
    n = 4 * math.prod(lat) * nb
    gen = torch.Generator(dev).manual_seed(1)
    on_card = comp._on_card
    comp._on_card = lambda t: False       # the plain bodies on the card
    try:
        m64 = comp.scale(comp.random_momentum(n, gen, torch.float64, dev),
                         0.1)
        x64 = comp.reunit(comp.from_complex_lattice(
            g.random((nb, 4, *lat, 3, 3), gen, torch.complex128, dev)))
        x64 = comp.F3(*(t + 1e-4 * torch.randn(t.shape, generator=gen,
                                               device=dev, dtype=t.dtype)
                        for t in x64))
        want = {"su3_expm_fwd": comp.expm(m64, order=8, s=2),
                "su3_reunit_fwd": comp.reunit(x64)}
    finally:
        comp._on_card = on_card
    inputs = {"su3_expm_fwd": m64, "su3_reunit_fwd": x64}
    kernels = {"su3_expm_fwd": lambda f: lk.expm(*f, 8, 2),
               "su3_reunit_fwd": lambda f: lk.reunit(*f)}
    plains = {"su3_expm_fwd": lambda f: comp.expm(f, order=8, s=2),
              "su3_reunit_fwd": comp.reunit}
    res = {name: {} for name in kernels}
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-13)):
        prec = str(dtype).replace("torch.", "")
        for name, kernel in kernels.items():
            f = comp.F3(*(t.to(dtype).contiguous() for t in inputs[name]))
            out = kernel(f)
            torch.cuda.synchronize()
            err = max(float((a.double() - b).abs().max())
                      for a, b in zip(out, want[name]))
            comp._on_card = lambda t: False
            try:
                plain_dev = kt.device_ms(lambda: plains[name](f), 3)
                plain_ms = kt.cuda_ms(lambda: plains[name](f), 20,
                                      batches=3)
            finally:
                comp._on_card = on_card
            ptx = next((u for fn, u in usage.items() if f"{name}_kernel"
                        in fn and ("IfE" if prec == "float32" else "IdE")
                        in fn), {})
            row = {
                "max_abs_err": err,
                "ms": kt.cuda_ms(lambda: kernel(f), 200, batches=5),
                "plain_ms": plain_ms,
                "device_ms": kt.device_ms(lambda: kernel(f),
                                          50)["device_ms_per_call"],
                "plain_device_ms": plain_dev["device_ms_per_call"],
                "plain_kernels_per_call": plain_dev["kernels_per_call"],
                # 36 launches a graph, as a draw's flow holds its expm's
                "graph_replay_ms": kt.graph_replay(lambda i: kernel(f), 36,
                                                   uk=uk)[0],
                "registers": ptx.get("registers"),
                "spill_stores": ptx.get("spill_stores"),
                "spill_loads": ptx.get("spill_loads"),
                **kt.su3_link_bound(name, lat, nb, dtype)}
            res[name][prec] = row
            emit({"phase": "su3_link_compare", "card": card, "kernel": name,
                  "lattice": list(lat), "nchains": nb, "dtype": prec,
                  **row})
            assert err <= tol, (name, prec, row)
    return res


def su3_flow_graph(torch, tr, x, card) -> None:
    """The flowed eval observables as evaluate() takes them on the card
    (a CUDA graph of the whole flow, replayed) against the eager flow on
    the same draw: bit for bit equal; both timed."""
    from l2hmc_torch.utils.kernel_times import cuda_ms
    graph = tr._flow_replay(x)
    eager = tr._flow_observables(x)
    torch.cuda.synchronize()
    equal = {k: torch.equal(graph[k], eager[k]) for k in eager}
    ms = {"graph": cuda_ms(lambda: tr._flow_replay(x), 5, warmup=1),
          "eager": cuda_ms(lambda: tr._flow_observables(x), 3, warmup=1)}
    emit({"phase": "su3_flow_graph", "card": card, "nchains": x.shape[0],
          "flow_steps": tr.cfg.flow_nsteps, "equal_to_eager": equal,
          "ms": ms})
    assert all(equal.values()), equal


def _step_kind(t, before) -> str:
    """How `t`'s last step ran, from its graphs' numbers before it."""
    after = t.graph_stats()
    if len(after) > len(before):
        return "capture"
    if sum(g["replays"] for g in after) > sum(g["replays"] for g in before):
        return "replay"
    return "eager"


def graph_steps(torch, card, name, tr, x, betas, eps, lr, n_eval) -> dict:
    """`tr` (a Trainer whose steps replay CUDA graphs) and its eager twin
    (`Trainer.twin(graphs=False)`) run the same sequence from one state:
    train steps at betas[0], betas[1] with the lr set to `lr` before the
    second; six more with grad_accum_steps=2 (three windows at betas[1],
    betas[0], betas[1], so that the accumulate-only and the update graph
    are each replayed after a beta change); 3 eval steps on the first
    n_eval chains; 4 HMC steps from there at eps[0], eps[0], eps[1],
    eps[1]. Held bit for bit: every loss and x, then the
    parameters, buffers (BN statistics, masks) and Adam moments and
    counts. Emits each one's largest difference, the graphs per key, the
    steps' times both ways with how each graphed step ran, and the
    graphs' capture and instantiation times and pool memory."""
    import statistics
    twin = tr.twin(graphs=False)
    k0 = tr.grad_accum_steps
    plan = [(betas[0], 1), (betas[1], 1)]
    if tr.step % 2:          # the accumulation windows start on an even step
        plan.insert(0, (betas[0], 1))
    lr_at = len(plan) - 1
    plan += [(b, 2) for b in (betas[1], betas[1], betas[0], betas[0],
                              betas[1], betas[1])]
    torch.cuda.reset_peak_memory_stats()
    res = {}
    for how, t in (("graphed", tr), ("eager", twin)):
        gen = torch.Generator(x.device).manual_seed(11)
        losses, xs = [], []
        ms = {"train": [], "eval": [], "hmc": []}
        kinds = {"train": [], "eval": [], "hmc": []}

        def timed(job, fn):
            before = t.graph_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[job].append((time.perf_counter() - t0) * 1e3)
            kinds[job].append(_step_kind(t, before))
            return out

        y = x.clone()
        for i, (b, k) in enumerate(plan):
            if i == lr_at:
                t.set_lr(lr)
            t.grad_accum_steps = k
            y, m = timed("train", lambda: t.train_step(y, b, gen))
            losses.append(m["loss"])
            xs.append(y)
        t.grad_accum_steps = k0
        ye = y[:n_eval].contiguous()
        for _ in range(3):
            ye, m = timed("eval", lambda: t.eval_step(ye, betas[1], gen))
            xs.append(ye)
        for e in (eps[0], eps[0], eps[1], eps[1]):
            ye, m = timed("hmc", lambda: t.hmc_step(ye, betas[1], e, gen))
            xs.append(ye)
        res[how] = {"losses": losses, "xs": xs, "ms": ms, "kinds": kinds}
    torch.cuda.synchronize()

    def maxdiff(pairs):
        return max((float((a.detach().double() if not a.is_complex()
                           else a).sub(b.detach().double() if not
                                       b.is_complex() else b).abs().max())
                    for a, b in pairs if a.numel()), default=0.0)
    g, e = res["graphed"], res["eager"]
    opt_pairs = []
    for p, q in zip(tr.dynamics.parameters(), twin.dynamics.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            opt_pairs.append((tr.optimizer.state[p][key],
                              twin.optimizer.state[q][key]))
    diff = {
        "loss": maxdiff(zip(g["losses"], e["losses"])),
        "x": maxdiff(zip(g["xs"], e["xs"])),
        "parameters": maxdiff(zip(tr.dynamics.parameters(),
                                  twin.dynamics.parameters())),
        "buffers_bn_masks": maxdiff(zip(tr.dynamics.buffers(),
                                        twin.dynamics.buffers())),
        "adam_moments_and_counts": maxdiff(opt_pairs),
    }
    equal = (all(torch.equal(a, b) for a, b in zip(g["losses"], e["losses"]))
             and all(torch.equal(a, b) for a, b in zip(g["xs"], e["xs"]))
             and all(torch.equal(a, b) for a, b in zip(
                 tr.dynamics.state_dict().values(),
                 twin.dynamics.state_dict().values()))
             and all(torch.equal(a, b) for a, b in opt_pairs))
    per_key: dict = {}
    for st in tr.graph_stats():
        label = (f"{st['job']} x{st['shapes']['x']} {st['flags']} "
                 f"accum {st['grad_accum_steps']}")
        per_key[label] = per_key.get(label, 0) + 1

    def replay_median(job):
        vals = [v for v, kind in zip(g["ms"][job], g["kinds"][job])
                if kind == "replay"]
        return statistics.median(vals) if vals else None
    out = {"phase": "graph_steps", "config": name, "card": card,
           "nchains": int(x.shape[0]), "n_eval": n_eval,
           "betas": list(betas), "eps": list(eps), "lr_set": lr,
           "bit_equal": equal, "max_abs_diff": diff,
           "graphs_per_key": per_key,
           "graphed_ms": g["ms"], "graphed_step_kinds": g["kinds"],
           "eager_ms": e["ms"],
           "median_ms": {job: {"graphed_replay": replay_median(job),
                               "eager": statistics.median(e["ms"][job])}
                         for job in ("train", "eval", "hmc")},
           "graphs": tr.graph_stats(),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    assert equal, diff
    assert all(n == 1 for n in per_key.values()), per_key
    for job in ("train", "eval", "hmc"):
        assert "replay" in g["kinds"][job], (job, g["kinds"])
    del twin
    return out


def graph_steps_only(torch, card) -> None:
    """`python3 chip_smoke.py graph_steps`: the graph_steps phase alone for
    its three configurations, each after a short run of its pipeline that
    captures its steps (U(1) default 3 + 3 + 3 steps; SU(3) 4^4 default
    the same; the 8^4 flowed loss with 20 warmup trajectories, 3 train
    steps and 2 draws each)."""
    from l2hmc_torch.experiment import build_experiment
    from l2hmc_torch.utils import su3_times as st
    runs = [("u1_default", "U1", [], (4.0, 4.5), (0.125, 0.1), 5e-4),
            ("su3_4x4_default", "SU3", [], (6.0, 5.5), (0.05, 0.04), 5e-4),
            ("su3_8x8_flowed_loss", "SU3",
             st.MAIN_SU3 + ["steps.warmup=20"], (5.7, 5.5), (0.02, 0.015),
             5e-5)]
    for name, group, extra, betas, eps, lr in runs:
        depth = ["steps.nepoch=2", "steps.test=2"] if extra else \
            ["steps.nepoch=3", "steps.test=3"]
        with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
            ex = build_experiment(extra + ["steps.nera=1", "save=false",
                                           *depth, f"outdir={out}"],
                                  group=group, device="cuda")
            ex.run()
        tr = ex.trainer
        n_eval = ex.cfg.nchains or max(2, ex.cfg.dynamics.nchains // 4)
        graph_steps(torch, card, name, tr, ex._x.contiguous(), betas, eps,
                    lr, n_eval)
        del ex, tr
        torch.cuda.empty_cache()


def su3_phases(torch, card, u1_ncp, link_usage) -> dict:
    """The SU(3) phases (8 in the list above). Returns the SU(3) kernels'
    numbers for the kernels line: their times and errors by dtype, and
    their launches in the 8^4 main path's run."""
    from l2hmc_torch import train4dsu3
    from l2hmc_torch.ops.kernels import launches as kl
    from l2hmc_torch.utils import su3_times as st
    from l2hmc_torch.utils.kernel_times import cuda_ms, profiled, raw_summary
    su3_compare(torch)
    force = su3_force_phase(torch, card)
    link = su3_link_phase(torch, card, link_usage)
    ex, _ = su3_run(torch, ["steps.nera=1", "steps.nepoch=20",
                            "steps.test=10", "save=true"],
                    "su3_default_path", flow=False)
    graph_steps(torch, card, "su3_4x4_default", ex.trainer,
                ex._x.contiguous(), (6.0, 5.5), (0.05, 0.04), 5e-4, 2)
    del ex
    # a fixed warmup budget, as the record's run has (1000 there): from
    # the ordered start the plaquette stands still while every proposal
    # is rejected, which the stationarity criterion would take for
    # equilibrium; 200 self-tuned trajectories thermalize the lattice
    ex, main_launches = su3_run(
        torch, st.MAIN_SU3 + ["steps.nera=1", "steps.nepoch=3",
                              "steps.test=3", "steps.warmup=200"],
        "su3_main_path", flow=True)
    tr, cfg = ex.trainer, ex.cfg
    x = ex._x.contiguous()
    beta = float(cfg.annealing_schedule.beta_final)
    eps = cfg.dynamics.eps_hmc
    nchains = cfg.dynamics.nchains
    su3_flow_graph(torch, tr, x, card)
    graph_steps(torch, card, "su3_8x8_flowed_loss", tr, x, (beta, 5.5),
                (eps, 0.015), 5e-5, nchains)

    def steps_of(t):
        def eval_draw():    # a draw as evaluate() makes it: step, then flow
            xo, _ = t.eval_step(x, beta, ex.generator)
            return t._flow_metrics(xo)

        def hmc_draw():
            xo, _ = t.hmc_step(x, beta, eps, ex.generator)
            return t._flow_metrics(xo)
        return {"train": lambda: t.train_step(x, beta, ex.generator),
                "eval": eval_draw, "hmc": hmc_draw}
    steps = steps_of(tr)
    # the force kernel's launches in one replayed step of each kind: in a
    # train step, the transition's first force (at the incoming x, which
    # carries no gradient) and the flowed loss's flow of the incoming x, 3
    # a flow step (the flow of the proposal wants a gradient: plain); in
    # an eval draw every force, 2 nleapfrog + 1 in the transition and 3 a
    # flow step in its Wilson flow
    nlf = cfg.dynamics.nleapfrog
    per_step, link_per_step = {}, {}
    for job, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        kl.reset()
        fn()
        torch.cuda.synchronize()
        per_step[job] = kl.counts()["su3_force_fwd"]
        link_per_step[job] = kl.counts("su3_expm_fwd", "su3_reunit_fwd")
    train_graph = [s["launches"] for s in tr.graph_stats()
                   if s["job"] == "train"]
    emit({"phase": "su3_force_launches_per_step", "per_step": per_step,
          "link_per_step": link_per_step, "train_graphs": train_graph})
    assert per_step["train"] == 1 + 3 * cfg.loss.charge_flow_nsteps, \
        per_step
    assert per_step["eval"] == 2 * nlf + 1 + 3 * cfg.flow_nsteps, per_step
    # an eval draw: 2 nleapfrog leapfrog steps of one expm and two reunits,
    # and 3 expm and one reunit a flow step, every one through the kernels
    assert link_per_step["eval"] == {
        "su3_expm_fwd": 2 * nlf + 3 * cfg.flow_nsteps,
        "su3_reunit_fwd": 4 * nlf + cfg.flow_nsteps}, link_per_step
    # the path and graph_steps have run, so the graphs exist: graphed
    # steps replay; an eager twin's step (~10 s) calls every engine op,
    # which are counted alongside (the flow of a draw is replayed from its
    # own graph either way)
    eager_tr = tr.twin(graphs=False)
    eager_steps = steps_of(eager_tr)
    with st.counting() as counts:
        eager_ms = {"train": cuda_ms(eager_steps["train"], 1, warmup=0)}
    # (the twin's first draw captures its own flow graph: not timed)
    eager_ms.update({job: cuda_ms(eager_steps[job], 2, warmup=1)
                     for job in ("eval", "hmc")})
    step_ms = {job: cuda_ms(steps[job], 3, warmup=1)
               for job in ("train", "eval", "hmc")}
    del eager_tr, eager_steps
    emit({"phase": "su3_step_times", "card": card, "ms": step_ms,
          "eager_ms": eager_ms, "graphs": tr.graph_stats(),
          "nchains": nchains, "lattice": list(cfg.dynamics.latvolume),
          "dtype": "float32", "flow_steps_per_draw": cfg.flow_nsteps})

    # the hot ops before the big profile: in a window opened right after
    # one of millions of events the profiler drops the first few records
    rows = st.hot_ops(cfg.dynamics.latvolume, nchains, tr.dynamics.real_dtype,
                      counts, device=x.device)
    rows["u1_ncp_x_update"] = u1_ncp
    emit({"phase": "su3_hot_ops", "card": card, "ops": rows})

    n_prof = 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prof = profiled(steps["train"], n_prof, warm=False)
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    # ~10^6 events a step: key_averages() would take minutes
    summary = raw_summary(prof)
    del prof
    kern, host = summary["kernels"], summary["host"]
    assert kern, "the profiler recorded no device kernel"
    busy_ms = sum(us for _, us in kern.values()) / 1e3
    top_dev = sorted(kern.items(), key=lambda kv: -kv[1][1])[:10]
    top_cpu = sorted(host.items(), key=lambda kv: -kv[1][1])[:10]
    # device time by kind of kernel: the networks' GEMMs and the
    # optimizer have names of their own; the engine, the flow and their
    # backward are the anonymous elementwise, reduce, roll and copy kernels
    kinds = {"network_gemm": ("gemm", "gemv"),
             "optimizer": ("multi_tensor", "Optimizer."),
             "reduce": ("reduce_kernel",), "roll_copy": ("roll_", "Memcpy")}
    by_kind = {kind: 0.0 for kind in (*kinds, "elementwise_other")}
    for name, (_, us) in kern.items():
        kind = next((k for k, pats in kinds.items()
                     if any(p in name for p in pats)), "elementwise_other")
        by_kind[kind] += us / 1e3 / n_prof
    emit({"phase": "su3_train_profile", "card": card, "steps": n_prof,
          "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms,
          # the profiler slows the host several times over: the share of
          # a step timed without it
          "device_busy_share_unprofiled": busy_ms / n_prof
          / step_ms["train"], "steps_run": "graphed",
          "device_kernels_per_step": sum(c for c, _ in kern.values())
          / n_prof, "host_events_per_step": sum(c for c, _ in host.values())
          / n_prof, "peak_memory_bytes": peak,
          "engine_calls_per_step": counts,
          "device_ms_per_step_by_kind": by_kind,
          "top_device_per_step": {k[:90]: {"count": c / n_prof,
                                           "ms": us / 1e3 / n_prof}
                                  for k, (c, us) in top_dev},
          "top_host_self_ms_per_step": {k[:70]: us / 1e3 / n_prof
                                        for k, (_, us) in top_cpu}})
    del ex, tr, x, steps
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc = train4dsu3.main(["steps.nepoch=5"])
    torch.cuda.synchronize()
    assert rc == 0, rc
    emit({"phase": "train4dsu3", "seconds": time.perf_counter() - t0,
          "train_steps": 5})
    return {"by_dtype": force, "launches": main_launches["su3_force_fwd"],
            "launches_per_step": per_step, "link": link,
            "link_launches": {k: main_launches[k] for k in link},
            "link_launches_per_step": link_per_step}


def su3_algebra_phase(torch) -> None:
    """log3x3, diffexp and su3_jacobian on the card against the same
    functions on the CPU, complex128 (1e-10)."""
    from l2hmc_torch.ops import su3 as g
    from l2hmc_torch.ops import su3_algebra as alg
    gen = torch.Generator().manual_seed(0)
    x = g.random((4096, 3, 3), gen)
    a = 0.3 * g.random_momentum((4096, 3, 3), gen)
    gm = g.expm(a[0], s=2)

    def fns(dev):
        xd, ad, gd = x.to(dev), a.to(dev), gm.to(dev)
        return {"log3x3": alg.log3x3(xd),
                "diffexp": alg.diffexp(alg.su3ad(ad)),
                "su3_jacobian": alg.su3_jacobian(lambda u: gd @ u, xd[0])[1]}

    cpu, card = fns("cpu"), fns("cuda")
    torch.cuda.synchronize()
    err = {k: float((card[k].cpu() - cpu[k]).abs().max()) for k in cpu}
    emit({"phase": "su3_algebra", "dtype": "complex128", "batch": 4096,
          "max_abs_err_card_vs_cpu": err})
    assert all(e <= 1e-10 for e in err.values()), err


def records_phase(torch, uk) -> None:
    """The record drivers at full width, cut in depth: the U(1) flagship
    (2048 x 16x16 train, 512 eval chains) for 10 train steps and 10 draws
    per protocol, its summary's key tree against the JAX record's; then
    the 64x64 bf16 record for 3 train, 3 eval and 3 HMC steps, whose
    networks must run their GEMMs in bfloat16 with every gradient finite
    and whose train_curve.json must hold one row per train step (the
    force kernels' launch counters are set to 0 before each of the two
    and read after it); then the SU(3) 8^4 beta 5.7 record for 20 warmup
    trajectories, 1 train step and 2 flowed draws each of eval and HMC,
    its flowed-topology statistics finite."""
    from l2hmc_torch.models import networks
    from l2hmc_torch.records import quality as q
    from l2hmc_torch.records import run_u1_flagship as fl
    with open(os.path.join(ROOT, "records",
                           "u1_16x16_quality_summary.json")) as f:
        want = q.key_tree(json.load(f))
    want["hmc_reference_literal"] = want["hmc_reference_protocol"]
    with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
        uk.reset_launch_counts()
        t0 = time.perf_counter()
        s = fl.main(out, extra=["steps.nepoch=10", "steps.test=10"],
                    device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = uk.launch_counts()
    got = q.key_tree(s)
    for k in ("se", "device", "commit"):
        assert k in got, k
        del got[k]
    assert got == want, (got, want)
    for k in ("eval_stats", "train", "eval"):
        assert finite(s[k]), (k, s[k])
    for k in ("hmc_reference_protocol", "hmc_tuned_baseline",
              "hmc_reference_literal"):
        assert finite(s[k]["improvement"]) and finite(s[k]["hmc_stats"]), \
            s[k]
        assert 0.0 < s[k]["hmc_stats"]["acc"] <= 1.0, s[k]
    assert 0.0 < s["eval_stats"]["acc"] <= 1.0, s["eval_stats"]
    assert s["config"]["nchains_train"] == 2048, s["config"]
    assert s["config"]["nchains_eval"] == 512, s["config"]
    assert launches["u1_force_fwd"] > 0 and launches["u1_force_bwd"] > 0, \
        launches
    emit({"phase": "records_u1_flagship", "seconds": seconds,
          "launches": launches, "eval_stats": s["eval_stats"],
          "improvement": {k: s[k]["improvement"] for k in
                          ("hmc_reference_protocol", "hmc_tuned_baseline",
                           "hmc_reference_literal")},
          "se": s["se"]})

    gemm_dtypes = set()
    functional = networks.F

    class RecordingF:
        """torch.nn.functional as the networks see it, noting the dtype of
        each GEMM's operands."""

        def __getattr__(self, name):
            return getattr(functional, name)

        def linear(self, z, w, b=None):
            gemm_dtypes.add((str(z.dtype), str(w.dtype)))
            return functional.linear(z, w, b)

    with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
        ex, rec = q.start("u1_64x64_bf16", out,
                          ["steps.nepoch=3", "steps.test=3"], device="cuda")
        assert ex.cfg.precision == "bfloat16", ex.cfg.precision
        networks.F = RecordingF()
        try:
            uk.reset_launch_counts()
            t0 = time.perf_counter()
            summary = ex.run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = uk.launch_counts()
        finally:
            networks.F = functional
        q.finish(ex, rec, dict(summary), out)
        with open(os.path.join(out, "train_curve.json")) as f:
            curve = json.load(f)
    assert [r[0] for r in curve["rows"]] == [1, 2, 3], curve
    assert finite(curve["rows"]), curve
    hist = ex.trainer.histories["train"].get_dataset()
    lat = list(ex.cfg.dynamics.latvolume)
    assert lat == [64, 64] and ex._x.shape[-1] == 2 * 64 * 64, ex._x.shape
    assert gemm_dtypes == {("torch.bfloat16", "torch.bfloat16")}, \
        gemm_dtypes
    assert ex._x.dtype == torch.float32, ex._x.dtype
    norms = hist["grad_norm"].ravel()
    assert norms.size == 3 and all(math.isfinite(v) and v > 0
                                   for v in norms), norms
    assert int((hist["grad_nonfinite"] != 0).sum()) == 0
    assert finite(summary), summary
    for job in ("eval_stats", "hmc_stats"):
        assert 0.0 < summary[job]["acc"] <= 1.0, summary[job]
    assert launches["u1_force_fwd"] > 0 and launches["u1_force_bwd"] > 0, \
        launches
    emit({"phase": "records_u1_64x64_bf16", "seconds": seconds,
          "launches": launches, "gemm_dtypes": sorted(gemm_dtypes),
          "grad_norm": [float(v) for v in norms],
          "train_curve_last": q.last_row(curve), "summary": summary})

    with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
        t0 = time.perf_counter()
        s = q.run("su3_8x8_b57", out, SU3_RECORD_DEPTH, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(os.path.join(out, "train_curve.json")) as f:
            curve = json.load(f)
    flowed = {job: {k: v for k, v in s[job].items()
                    if k.startswith("flowQ_") or k == "dQint_flow"}
              for job in ("eval_stats", "hmc_stats")}
    emit({"phase": "records_su3_8x8_b57", "seconds": seconds,
          "lattice": [8, 8, 8, 8], "train_curve_last": q.last_row(curve),
          "flowed": flowed, "improvement": s["improvement"]})
    for job, stats in flowed.items():
        assert {"flowQ_mean_abs", "dQint_flow", "flowQ_sector_Q2",
                "flowQ_max_abs_sector"} <= set(stats), (job, stats)
        assert finite(stats), (job, stats)
    assert [r[0] for r in curve["rows"]] == [1] and finite(curve["rows"])
    assert {"sumlogdet", "plaqs"} <= set(curve["columns"]), curve["columns"]


def records_su3_frozen_phase(torch) -> None:
    """The 8^4 beta 5.7 record with lr 0 (`su3_8x8_b57_frozen`) at the
    smoke depth of `records_su3_8x8_b57`: after its train step every
    parameter is bit-equal to its value before, grad_norm is finite and
    above 0 (the gradient is still computed), and sumlogdet is 0 on every
    chain (the networks stay at their zero init)."""
    from l2hmc_torch.records import quality as q
    with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
        ex, rec = q.start("su3_8x8_b57_frozen", out, SU3_RECORD_DEPTH,
                          device="cuda")
        params = dict(ex.trainer.dynamics.named_parameters())
        before = {n: p.detach().clone() for n, p in params.items()}
        t0 = time.perf_counter()
        s = q.finish(ex, rec, ex.run(), out)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(os.path.join(out, "train_health.json")) as f:
            health = json.load(f)
        with open(os.path.join(out, "train_curve.json")) as f:
            curve = json.load(f)
    moved = sorted(n for n, p in params.items()
                   if not torch.equal(p.detach(), before[n]))
    sumlogdet = ex.trainer.histories["train"].get_dataset()["sumlogdet"]
    emit({"phase": "records_su3_frozen", "seconds": seconds,
          "lr": ex.trainer.lr,
          "updates": ex.trainer.updates, "params": len(params),
          "moved": moved, "health": health,
          "train_curve_last": q.last_row(curve),
          "improvement": s["improvement"]})
    assert ex.cfg.learning_rate.lr_init == 0 and ex.trainer.updates == 1
    assert not moved, moved
    assert health["train_steps"] == 1, health
    assert health["grad_norm_finite_positive"], health
    assert health["steps_grad_nonfinite"] == 0, health
    assert sumlogdet.size == 8 and (sumlogdet == 0).all(), sumlogdet
    assert finite(curve["rows"]) and finite(s["eval_stats"]), s


def trainer_profile_phase(torch, card) -> None:
    """`Trainer.profile` for 2 train steps at the default U(1) width on
    the card, replayed from the step's CUDA graph (its first, eager step
    and its capture untraced): the Chrome trace must exist and hold both
    force kernels, as often as two train steps launch them."""
    from l2hmc_torch.configs import get_config
    from l2hmc_torch.train.trainer import Trainer
    tr = Trainer(get_config([]), device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    beta = float(tr.cfg.annealing_schedule.beta_init)
    x = tr.random_x(gen)
    for _ in range(2):                          # set-up untraced
        x, _ = tr.train_step(x, beta, gen)
    nsteps, nlf = 2, tr.cfg.dynamics.nleapfrog
    with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
        t0 = time.perf_counter()
        tr.profile(x, beta, gen, nsteps=nsteps, outdir=out)
        seconds = time.perf_counter() - t0
        (path,) = glob.glob(os.path.join(out, "*.json"))
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    found = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for k in ("u1_force_fwd", "u1_force_bwd"):
            if f"{k}_kernel" in e.get("name", ""):
                n, us = found.get(k, (0, 0.0))
                found[k] = (n + 1, us + float(e.get("dur", 0.0)))
    assert tr.graph_stats()[0]["replays"] == 1 + nsteps, tr.graph_stats()
    emit({"phase": "trainer_profile", "card": card, "steps": nsteps,
          "seconds": seconds, "trace": path, "trace_bytes": size,
          "kernels": {k: {"launches": n, "device_us_per_launch": us / n}
                      for k, (n, us) in found.items()}})
    # per train step 4 nlf + 2 forward and 2 nlf + 1 backward launches
    assert {k: n for k, (n, _) in found.items()} == {
        "u1_force_fwd": nsteps * (4 * nlf + 2),
        "u1_force_bwd": nsteps * (2 * nlf + 1)}, found


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def parallel_phases(torch, uk) -> None:
    """dp_u1_path and sharded_su3_path in one NCCL process group of world
    size 1, which is torn down afterwards."""
    from l2hmc_torch.experiment import build_experiment
    from l2hmc_torch.parallel import mesh as pmesh
    from l2hmc_torch.parallel.sharded_train import ShardedTrainerSU3
    from l2hmc_torch.train.trainer import Trainer
    from l2hmc_torch.utils import su3_times as st
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
            ex = build_experiment(["mesh_shape=[1, 1]", "steps.nera=1",
                                   "steps.nepoch=3", "steps.test=3",
                                   "save=true", f"outdir={out}"],
                                  device="cuda")
            assert torch.distributed.get_backend() == "nccl"
            uk.reset_launch_counts()
            t0 = time.perf_counter()
            summary = ex.run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = uk.launch_counts()
        assert finite(summary), summary
        assert launches["u1_force_fwd"] > 0 and launches["u1_force_bwd"] > 0
        dp, cfg = ex.trainer, ex.cfg
        assert dp.mesh is not None and dp.mesh.shape == (1, 1)
        # one step from the run's state and one set of draws, with the mesh
        # and without: at world 1 every collective is the identity
        plain = Trainer(cfg, device="cuda")
        plain.dynamics.load_state_dict(dp.dynamics.state_dict())
        # a deep copy: load_state_dict would share the moment tensors
        plain.load_optimizer_state(copy.deepcopy(dp.optimizer.state_dict()))
        plain.step, plain.updates = dp.step, dp.updates
        x = ex._x.contiguous()
        gen = torch.Generator(x.device).manual_seed(1)
        draws = {"v": dp.dynamics.random_v(x, gen),
                 "dropout_masks": dp.dynamics.random_dropout_masks(
                     x.shape[0], gen),
                 "u": torch.rand((x.shape[0],), generator=gen,
                                 device=x.device)}
        beta = float(cfg.annealing_schedule.beta_final)
        dp.mesh.counts.clear()
        x1, m1 = dp.train_step(x, beta, draws=draws)
        collectives = dict(dp.mesh.counts)
        x0, m0 = plain.train_step(x, beta, draws=draws)
        torch.cuda.synchronize()
        equal = (torch.equal(x1, x0) and torch.equal(m1["loss"], m0["loss"])
                 and all(torch.equal(a, b) for a, b in zip(
                     dp.dynamics.state_dict().values(),
                     plain.dynamics.state_dict().values())))
        emit({"phase": "dp_u1_path", "seconds": seconds,
              "backend": "nccl", "world_size": 1, "mesh_shape": [1, 1],
              "launches": launches, "collectives_per_train_step": collectives,
              "train_step_bit_equal_to_no_mesh": equal, "summary": summary})
        assert equal, "the mesh's train step differs from the Trainer's"
        assert collectives.get("all_reduce", 0) > 0, collectives
        del ex, dp, plain
        torch.cuda.empty_cache()

        cfg = st.MAIN_SU3 + ["loss.charge_flow_nsteps=0", "flow_nsteps=0",
                             "dynamics.cold_start=false"]
        from l2hmc_torch.configs import get_config
        cfg = get_config(cfg, group="SU3")
        mesh = pmesh.Mesh(1, 1)
        # the sharded steps on a second Trainer's dynamics and optimizer
        # update (the Trainer routes only l > 1 here; the class is sound
        # at 1), against the Trainer's own steps from the same weights
        two = Trainer(cfg, device="cuda")
        sh = ShardedTrainerSU3(cfg, mesh, two.device, two.dynamics,
                               two._optimizer_update)
        one = Trainer(cfg, device="cuda")
        gen = torch.Generator("cuda").manual_seed(2)
        x = one.dynamics.random_x(gen)
        draws = {"v": one.dynamics.random_v(x, gen),
                 "u": torch.rand((x.shape[0],), generator=gen,
                                 device=x.device)}
        beta = float(cfg.annealing_schedule.beta_final)
        mesh.counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, ms = sh.train_step(sh.shard(x), beta, draws=draws)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        collectives = dict(mesh.counts)
        x0, m0 = one.train_step(x, beta, draws=draws)
        rel = float(abs(ms["loss"] - m0["loss"]) / abs(m0["loss"]))
        # Adam's first update is ~lr * sign(g): the parameters alone would
        # not see a gradient off by a constant factor
        grel = float(abs(ms["grad_norm"] - m0["grad_norm"])
                     / m0["grad_norm"])
        perr = max(float((a.detach() - b.detach()).abs().max()) for a, b
                   in zip(sh.dynamics.parameters(),
                          one.dynamics.parameters()))
        xerr = float((sh.gather(xs) - x0).abs().max())
        t0 = time.perf_counter()
        xs, ms2 = sh.train_step(xs, beta, gen)
        xs, me = sh.eval_step(xs, beta, gen)
        xs, mh_ = sh.hmc_step(xs, beta, cfg.dynamics.eps_hmc,
                              2 * cfg.dynamics.nleapfrog, gen)
        torch.cuda.synchronize()
        rest_s = time.perf_counter() - t0
        metrics = {"loss": [float(ms["loss"]), float(ms2["loss"])],
                   "grad_norm": [float(ms["grad_norm"]),
                                 float(ms2["grad_norm"])],
                   "eval_acc": float(me["acc"].mean()),
                   "hmc_acc": float(mh_["acc"].mean())}
        emit({"phase": "sharded_su3_path", "mesh_shape": [1, 1],
              "lattice": list(cfg.dynamics.latvolume),
              "nchains": cfg.dynamics.nchains, "dtype": "float32",
              "first_train_step_ms": first_ms,
              "train_eval_hmc_seconds": rest_s,
              "collectives_first_train_step": collectives,
              "loss_rel_err_vs_trainer": rel,
              "grad_norm_rel_err_vs_trainer": grel,
              "param_max_abs_err_vs_trainer": perr,
              "x_max_abs_err_vs_trainer": xerr, **metrics})
        assert finite(metrics) and metrics["grad_norm"][0] > 0, metrics
        assert int(ms["grad_nonfinite"]) == 0
        assert rel <= 1e-5 and grel <= 1e-5, (rel, grel)
        assert perr <= 1e-5 and xerr <= 1e-5, (perr, xerr)
    finally:
        pmesh.teardown_distributed()
        for k in env:
            os.environ.pop(k, None)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from l2hmc_torch.experiment import build_experiment
    from l2hmc_torch.ops.kernels import su3_link as lk
    from l2hmc_torch.ops.kernels import u1_force as uk
    from l2hmc_torch.utils import kernel_times as kt
    from l2hmc_torch.utils import su3_times as st
    from l2hmc_torch.utils.kernel_times import (card_line, cuda_ms,
                                                device_kernels, device_ms,
                                                profiled)

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib, nvcc_out = uk.build(verbose=True)
    print(nvcc_out, file=sys.stderr, flush=True)
    emit({"phase": "build", "library": os.path.relpath(lib, ROOT),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    link_lib, link_out = lk.build(verbose=True)
    print(link_out, file=sys.stderr, flush=True)
    link_usage = kt.ptxas_usage(link_out)
    emit({"phase": "build", "library": os.path.relpath(link_lib, ROOT),
          "seconds": time.perf_counter() - t0, "ptxas": link_usage})
    if sys.argv[1:] == ["graph_steps"]:
        graph_steps_only(torch, card)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(dev).manual_seed(0)
    beta = 4.0
    errs = {}
    # (chains, nt, nx, dtype, what the shape is there for)
    for nb, nt, nx, dtype, why in [
            (2048, 16, 16, torch.float32, "main path"),
            (2048, 16, 16, torch.float64, "main path, float64"),
            (37, 8, 12, torch.float32, "ragged, nx not a power of two"),
            (64, 64, 64, torch.float32, "a block per chain"),
            (64, 64, 64, torch.float64, "a block per chain, float64"),
            (1500, 64, 64, torch.float32, "a block per chain, several passes"),
            (37, 5, 7, torch.float32, "odd nt*nx: ordinary loads"),
            (37, 5, 7, torch.float64, "odd nt*nx, float64"),
            (300, 32, 32, torch.float32, "32x32: a warp per chain"),
            (1, 16, 16, torch.float32, "one chain"),
            (5000, 16, 16, torch.float32, "more than one pass of the grid"),
            (100000, 4, 4, torch.float64, "many passes, deep ring"),
            (2047, 16, 16, torch.float32, OFF_ALIGNMENT)]:
        f32 = dtype == torch.float32
        shape = (nb, 2 * nt * nx)
        x = (torch.rand(shape, generator=gen, device=dev, dtype=dtype) * 2
             - 1) * math.pi
        if why == OFF_ALIGNMENT:
            x = kt.offset_view(x)
            assert x.data_ptr() % 16 != 0 and x.is_contiguous()
        # beta from device memory, as the steps pass it
        bd = torch.full((), beta, dtype=dtype, device=dev)
        f, a = uk.force_action(x, bd, nt, nx)
        fp, ap = uk.force_action_plain(x, beta, nt, nx)
        gf = torch.randn(x.shape, generator=gen, device=dev, dtype=dtype)
        gs = torch.randn((nb,), generator=gen, device=dev, dtype=dtype)
        b = uk.force_action_bwd(x, gf, gs, f, bd, nt, nx)
        bp = uk.force_action_bwd_plain(x, gf, gs, f, beta, nt, nx)
        # gS absent (what the training path sends) against gS = 0
        b0 = uk.force_action_bwd(x, gf, None, None, bd, nt, nx)
        b0p = uk.force_action_bwd_plain(x, gf, torch.zeros_like(gs), f, beta,
                                        nt, nx)
        torch.cuda.synchronize()
        # force: atol 2e-5 (f32, as the Pallas kernel is held) / 1e-12
        # (f64); action: rtol 2e-5 / 1e-12; backward (values up to ~30 at
        # beta 4): atol 1e-4 / 1e-10
        torch.testing.assert_close(f, fp, atol=2e-5 if f32 else 1e-12,
                                   rtol=0)
        torch.testing.assert_close(a, ap, atol=0, rtol=2e-5 if f32 else 1e-12)
        torch.testing.assert_close(b, bp, atol=1e-4 if f32 else 1e-10,
                                   rtol=0)
        torch.testing.assert_close(b0, b0p, atol=1e-4 if f32 else 1e-10,
                                   rtol=0)
        err = {"fwd": float((f - fp).abs().max()),
               "act_rel": float(((a - ap).abs() / ap.abs()).max()),
               "bwd": float((b - bp).abs().max()),
               "bwd_no_gs": float((b0 - b0p).abs().max())}
        errs[(nb, nt, nx, str(dtype))] = err
        emit({"phase": "compare", "shape": [nb, 2 * nt * nx], "nt": nt,
              "nx": nx, "dtype": str(dtype).replace("torch.", ""),
              "why": why, "beta": "device scalar", "max_abs_err": err})
    xg = (torch.rand((3, 2 * 4 * 4), generator=gen, device=dev,
                     dtype=torch.float64) * 2 - 1) * math.pi
    assert torch.autograd.gradcheck(
        lambda y: uk.force_action_ad(y, 1.3, 4, 4), (xg.requires_grad_(),))
    emit({"phase": "gradcheck", "ok": True})

    # -- 4. the main path -------------------------------------------------------
    nera, nepoch, ntest = 1, 10, 10
    with tempfile.TemporaryDirectory(prefix="l2hmc_torch_smoke_") as out:
        ex = build_experiment([f"steps.nera={nera}", f"steps.nepoch={nepoch}",
                               f"steps.test={ntest}", "save=true",
                               f"outdir={out}"], device="cuda")
        cfg = ex.cfg
        nlf = cfg.dynamics.nleapfrog
        uk.reset_launch_counts()
        t0 = time.perf_counter()
        summary = ex.run()
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = uk.launch_counts()
        saved = sorted(os.listdir(os.path.join(out, "checkpoints")))
        assert saved and os.path.exists(os.path.join(out, "xeps.txt"))
    tr = ex.trainer
    hist = tr.histories["train"].get_dataset()
    assert finite(summary), summary
    for job in ("eval_stats", "hmc_stats"):
        assert 0.0 < summary[job]["acc"] <= 1.0, summary[job]
    assert int(hist["grad_nonfinite"].sum()) == 0
    # per step: train 2(nlf+1) forward + 2 nlf recomputed under
    # checkpoint, 2 nlf + 1 backward (the first force acts on the initial
    # x, which carries no gradient); eval 2(nlf+1); HMC 2 nlf + 1
    per_step = {"train": (4 * nlf + 2, 2 * nlf + 1), "eval": (2 * nlf + 2, 0),
                "hmc": (2 * nlf + 1, 0)}
    assert launches["u1_force_bwd"] == nepoch * per_step["train"][1], \
        launches
    least_fwd = (nepoch * per_step["train"][0] + ntest * per_step["eval"][0]
                 + ntest * per_step["hmc"][0])
    assert launches["u1_force_fwd"] >= least_fwd, launches
    assert tr.use_graphs and tr.graph_stats(), "the main path took no graph"
    emit({"phase": "main_path", "seconds": main_s, "launches": launches,
          "graphs": tr.graph_stats(), "summary": summary})

    x = ex._x.contiguous()
    beta_f = float(cfg.annealing_schedule.beta_final)
    xe = x[: max(2, cfg.dynamics.nchains // 4)].contiguous()
    eps = cfg.dynamics.eps_hmc
    steps = {
        "train": lambda: tr.train_step(x, beta_f, ex.generator),
        "eval": lambda: tr.eval_step(xe, beta_f, ex.generator),
        "hmc": lambda: tr.hmc_step(xe, beta_f, eps, ex.generator),
    }
    for job, fn in steps.items():
        uk.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        got = uk.launch_counts()
        assert (got["u1_force_fwd"], got["u1_force_bwd"]) == per_step[job], \
            (job, got)
    emit({"phase": "launches_per_step",
          "per_step": {k: {"u1_force_fwd": v[0], "u1_force_bwd": v[1]}
                       for k, v in per_step.items()}})

    # -- 5. one trajectory's launches in a CUDA graph ---------------------------
    nb, nt, nx = cfg.dynamics.nchains, *cfg.dynamics.latvolume
    xk = (torch.rand((nb, 2 * nt * nx), generator=gen, device=dev) * 2 - 1) \
        * math.pi
    fk, ak = uk.force_action(xk, beta, nt, nx)
    gk = torch.randn(xk.shape, generator=gen, device=dev)
    gsk = torch.randn((nb,), generator=gen, device=dev)
    calls = {
        "fwd": lambda i=0: uk.force_action(xk, beta, nt, nx),
        "bwd": lambda i=0: uk.force_action_bwd(xk, gk, gsk, fk, beta, nt, nx),
        # what the training path sends: the action unused, gS absent
        "bwd_no_gs": lambda i=0: uk.force_action_bwd(xk, gk, None, None, beta,
                                                     nt, nx),
    }
    # beta from device memory, as on the main path; a graph captured at
    # one beta replays at whatever the scalar then holds
    beta = torch.full((), beta, device=dev)
    n_graph = 2 * nlf + 1
    bk0 = calls["bwd_no_gs"]()
    replay_ms = {}
    for key, eager in [("fwd", (fk, ak)), ("bwd_no_gs", (bk0,))]:
        replay_ms[key], outs = kt.graph_replay(calls[key], n_graph, uk=uk)
        torch.cuda.synchronize()
        for out in outs:
            out = out if isinstance(out, tuple) else (out,)
            assert all(torch.equal(o, e) for o, e in zip(out, eager)), key
    graph = torch.cuda.CUDAGraph()
    with uk.captured_launches() as rec, torch.cuda.graph(graph):
        g_out = calls["fwd"]() + (calls["bwd_no_gs"](),)
    beta.fill_(2.5)
    graph.replay()
    uk.count_replay(rec)
    at_2_5 = calls["fwd"]() + (calls["bwd_no_gs"](),)
    plain_2_5 = uk.force_action_plain(xk, 2.5, nt, nx) + (
        uk.force_action_bwd_plain(xk, gk, None, None, 2.5, nt, nx),)
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(g_out, at_2_5))
    torch.testing.assert_close(g_out[0], plain_2_5[0], atol=2e-5, rtol=0)
    torch.testing.assert_close(g_out[1], plain_2_5[1], atol=0, rtol=2e-5)
    torch.testing.assert_close(g_out[2], plain_2_5[2], atol=1e-4, rtol=0)
    beta_err = [float((o - e).abs().max()) for o, e in zip(g_out, plain_2_5)]
    beta.fill_(4.0)
    del graph
    emit({"phase": "graph_capture", "card": card, "launches_per_graph":
          n_graph, "equal_to_eager": True, "replay_ms_per_launch": replay_ms,
          "captured_at_beta_4_replayed_at_2.5": {
              "equal_to_eager_at_2.5": True,
              "max_abs_err_vs_plain_fwd_act_bwd": beta_err}})

    # -- 6. times -------------------------------------------------------------
    reps, batches = 200, 5      # the median of 5 means over 200 calls
    t = {key: cuda_ms(fn, reps, batches=batches) for key, fn in [
        ("fwd_plain", lambda: uk.force_action_plain(xk, beta, nt, nx)),
        ("fwd", calls["fwd"]),
        ("bwd", calls["bwd"]),
        ("bwd_no_gs", calls["bwd_no_gs"]),
        ("bwd_no_gs_plain", lambda: uk.force_action_bwd_plain(
            xk, gk, None, None, beta, nt, nx)),
        ("bwd_plain", lambda: uk.force_action_bwd_plain(
            xk, gk, gsk, fk, beta, nt, nx))]}
    emit({"phase": "kernel_times", "card": card, "shape": [nb, 2 * nt * nx],
          "dtype": "float32", "reps": reps, "batches": batches, "ms": t})
    # the steps as the Trainer takes them (replayed from their graphs)
    # and an eager twin of the same state, the counterpart of
    # jax.disable_jit()
    eager_tr = tr.twin(graphs=False)
    eager_steps = {
        "train": lambda: eager_tr.train_step(x, beta_f, ex.generator),
        "eval": lambda: eager_tr.eval_step(xe, beta_f, ex.generator),
        "hmc": lambda: eager_tr.hmc_step(xe, beta_f, eps, ex.generator),
    }
    step_ms = {job: cuda_ms(fn, 20 if job == "train" else 50,
                            warmup=3) for job, fn in steps.items()}
    eager_ms = {job: cuda_ms(fn, 5 if job == "train" else 20,
                             warmup=1) for job, fn in eager_steps.items()}
    emit({"phase": "step_times", "card": card, "ms": step_ms,
          "eager_ms": eager_ms, "graphs": tr.graph_stats(),
          "nchains": {"train": nb, "eval": int(xe.shape[0]),
                      "hmc": int(xe.shape[0])}})

    # device time of the kernels alone (the event times above include
    # whatever the host's enqueue rate imposes), and the train step's
    # device busy share, kernels per step and host hot spots
    k_reps = 50
    kernel_dev_ms = {key: device_ms(fn, k_reps) for key, fn in [
        ("fwd", calls["fwd"]),
        ("fwd_plain", lambda: uk.force_action_plain(xk, beta, nt, nx)),
        ("bwd", calls["bwd"]),
        ("bwd_no_gs", calls["bwd_no_gs"]),
        ("bwd_plain", lambda: uk.force_action_bwd_plain(
            xk, gk, gsk, fk, beta, nt, nx))]}
    emit({"phase": "kernel_device_times", "card": card, "reps": k_reps,
          "shape": [nb, 2 * nt * nx], "dtype": "float32",
          "profiler": kernel_dev_ms})
    # per shape: event, device, graph-replay and cold-L2 times, bytes, bound
    for shape in kt.SHAPES:
        emit({"phase": "kernel_times_by_shape", "card": card,
              **kt.measure(uk, *shape)})

    n_prof = 3
    for how, fn in (("graphed", steps["train"]),
                    ("eager", eager_steps["train"])):
        t0 = time.perf_counter()
        prof = profiled(fn, n_prof)
        wall_ms = (time.perf_counter() - t0) * 1e3
        kern = device_kernels(prof)
        busy_ms = sum(us for _, us in kern.values()) / 1e3
        top_dev = sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]
        top_cpu = sorted(prof.key_averages(),
                         key=lambda e: -e.self_cpu_time_total)[:8]
        emit({"phase": "train_profile", "steps_run": how, "card": card,
              "steps": n_prof, "wall_ms_profiled": wall_ms,
              "device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / wall_ms if kern else None,
              "device_busy_share_unprofiled": busy_ms / n_prof
              / (step_ms if how == "graphed" else eager_ms)["train"],
              "device_kernels_per_step": sum(c for c, _ in kern.values())
              / n_prof,
              "fill_kernels_per_step": sum(c for k, (c, _) in kern.items()
                                           if "FillFunctor" in k) / n_prof,
              "top_device_ms": {k[:70]: us / 1e3 for k, (_, us) in top_dev},
              "top_host_self_ms": {e.key[:70]: e.self_cpu_time_total / 1e3
                                   for e in top_cpu}})
    del eager_tr, eager_steps

    graph_steps(torch, card, "u1_default", tr, x, (beta_f, beta_f + 0.5),
                (eps, 0.8 * eps), 0.5 * tr.lr, int(xe.shape[0]))
    u1_conv_path(torch, uk)
    # 2 x-updates a leapfrog step, 2 nlf steps, run and recomputed
    u1_ncp = st.u1_ncp_row(tr.dynamics, nb, calls=8 * nlf)
    del ex, tr, x, xe, steps, prof
    torch.cuda.empty_cache()
    su3 = su3_phases(torch, card, u1_ncp, link_usage)
    su3_algebra_phase(torch)
    parallel_phases(torch, uk)
    records_phase(torch, uk)
    records_su3_frozen_phase(torch)
    trainer_profile_phase(torch, card)

    # -- the kernels line -----------------------------------------------------
    # `ms` is the CUDA-event time of back-to-back wrapper calls (host
    # enqueue included) at the main path's shape and, for the backward,
    # in the main path's case: gS absent. The backward with gS is beside it.
    err = errs[(nb, nt, nx, str(torch.float32))]
    rows = []
    for name, key, func in [("u1_force_fwd", "fwd", "_kernel"),
                            ("u1_force_bwd", "bwd_no_gs", "_fa_bwd")]:
        bd = kt.bound(key, nb, nt, nx, torch.float32)
        rows.append({
            "name": name, "route": "cuda",
            "source": "l2hmc_torch/csrc/u1_force.cu",
            "replaces": replaces(func), "launches": launches[name],
            "max_abs_err": err[key], "ms": t[key],
            "plain_ms": t[key + "_plain"], "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "library_ms": None,
            "device_ms": kernel_dev_ms[key]["device_ms_per_call"],
            "graph_replay_ms": replay_ms[key],
        })
    with_gs = kt.bound("bwd", nb, nt, nx, torch.float32)
    rows[1].update({"with_gs_ms": t["bwd"], "with_gs_plain_ms": t["bwd_plain"],
                    "with_gs_bound_ms": with_gs["bound_ms"],
                    "with_gs_max_abs_err": err["bwd"]})
    # the SU(3) force at the draw's shape (8^4 x 8 chains), float32 and,
    # beside it, float64; its launches in the 8^4 main path's run
    f32, f64 = su3["by_dtype"]["float32"], su3["by_dtype"]["float64"]
    rows.append({
        "name": "su3_force_fwd", "route": "cuda",
        "source": "l2hmc_torch/csrc/su3_force.cu",
        "replaces": "no TPU kernel: plain jnp at "
                    + replaces("force_and_traces", "su3_comp.py"),
        "launches": su3["launches"],
        "launches_per_step": su3["launches_per_step"],
        "max_abs_err": f32["max_abs_err"],
        "trace_err_per_plaquette": f32["trace_err_per_plaquette"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": None, "device_ms": f32["device_ms"],
        "plain_device_ms": f32["plain_device_ms"],
        "graph_replay_ms": f32["graph_replay_ms"],
        "float64": {k: f64[k] for k in (
            "max_abs_err", "trace_err_per_plaquette", "ms", "plain_ms",
            "bound_ms", "device_ms", "graph_replay_ms")}})
    # the SU(3) link maps at the draw's shape, float32 and float64; their
    # launches in the 8^4 main path's run
    for name, func in (("su3_expm_fwd", "expm"),
                       ("su3_reunit_fwd", "reunit")):
        f32, f64 = (su3["link"][name][d] for d in ("float32", "float64"))
        rows.append({
            "name": name, "route": "cuda",
            "source": "l2hmc_torch/csrc/su3_link.cu",
            "replaces": "no TPU kernel: plain jnp at "
                        + replaces(func, "su3_comp.py"),
            "launches": su3["link_launches"][name],
            "launches_per_step": {job: c[name] for job, c in
                                  su3["link_launches_per_step"].items()},
            "library_ms": None, **f32,
            "float64": {k: f64[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "device_ms",
                "plain_device_ms", "graph_replay_ms", "registers",
                "spill_stores", "spill_loads")}})
    assert all(r["launches"] > 0 for r in rows), rows
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
