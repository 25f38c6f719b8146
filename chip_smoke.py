#!/usr/bin/env python3
"""Smoke run of the PyTorch port (l2hmc_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from l2hmc_torch/csrc/ (nvcc, -Xptxas -v);
  3. hold each kernel against its plain PyTorch version on the card, at
     the main-path shape (2048 x 2x16x16, float32 and float64), a ragged
     one (37 x 2x8x12), the 64x64 lattice, and the shapes that take the
     kernels' other paths: odd nt*nx (37 x 2x5x7, no 16-byte copies),
     32x32, one chain, more chains than one pass of the persistent grid
     holds (5000), and a view that is not 16-byte aligned; the backward
     also without gS, against the plain version with gS = 0; gradcheck
     the autograd.Function at float64;
  4. the main path: `build_experiment(...).run()` at the default U(1)
     width (2048 chains, 16x16, nleapfrog 8, units [16]*4, BatchNorm and
     dropout on) for one era of 20 train steps, then 20 eval and 20 HMC
     draws, with the kernels' launch counters set to 0 just before and
     read just after; then one train, eval and HMC step each, counted
     alone against the launches expected per step;
  5. one trajectory's launches (17 forward, 17 backward) captured in a
     CUDA graph, replayed, and held bit for bit against the eager calls;
  6. times, with CUDA events after warmup: each kernel and its plain
     version at the main-path shape, a train, an eval and an HMC step;
     the kernels' device time (torch.profiler), and per shape (16x16,
     64x64 float32 and float64) their event, device, graph-replay and
     cold-L2 times with bytes and bound (l2hmc_torch.utils.kernel_times);
     the device's busy share over a few train steps.
Each result is one JSON line. The line before the last is
{"kernels": [...]} with each kernel's launches, error, times and bound;
the last is {"ok": true, "device": {...}}.

Without CUDA, or run from a directory that holds no l2hmc_torch, it
exits non-zero before printing any result.
"""
from __future__ import annotations

import glob
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def replaces(func: str) -> str:
    """file:line of the TPU kernel function in the JAX package."""
    (path,) = glob.glob(os.path.join(ROOT, "*", "ops", "pallas",
                                     "u1_kernels.py"))
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if line.startswith(f"def {func}("):
                return f"{os.path.relpath(path, ROOT)}:{n}"
    raise RuntimeError(f"{func} not found in {path}")


OFF_ALIGNMENT = "a view that is not 16-byte aligned"


def finite(v) -> bool:
    if isinstance(v, dict):
        return all(finite(x) for x in v.values())
    return isinstance(v, (int, float)) and math.isfinite(v)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from l2hmc_torch.experiment import build_experiment
    from l2hmc_torch.ops.kernels import u1_force as uk
    from l2hmc_torch.utils import kernel_times as kt
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
        f, a = uk.force_action(x, beta, nt, nx)
        fp, ap = uk.force_action_plain(x, beta, nt, nx)
        gf = torch.randn(x.shape, generator=gen, device=dev, dtype=dtype)
        gs = torch.randn((nb,), generator=gen, device=dev, dtype=dtype)
        b = uk.force_action_bwd(x, gf, gs, f, beta, nt, nx)
        bp = uk.force_action_bwd_plain(x, gf, gs, f, beta, nt, nx)
        # gS absent (what the training path sends) against gS = 0
        b0 = uk.force_action_bwd(x, gf, None, None, beta, nt, nx)
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
              "why": why, "max_abs_err": err})
    xg = (torch.rand((3, 2 * 4 * 4), generator=gen, device=dev,
                     dtype=torch.float64) * 2 - 1) * math.pi
    assert torch.autograd.gradcheck(
        lambda y: uk.force_action_ad(y, 1.3, 4, 4), (xg.requires_grad_(),))
    emit({"phase": "gradcheck", "ok": True})

    # -- 4. the main path -------------------------------------------------------
    nera, nepoch, ntest = 1, 20, 20
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
    emit({"phase": "main_path", "seconds": main_s, "launches": launches,
          "summary": summary})

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
    n_graph = 2 * nlf + 1
    bk0 = calls["bwd_no_gs"]()
    replay_ms = {}
    for key, eager in [("fwd", (fk, ak)), ("bwd_no_gs", (bk0,))]:
        replay_ms[key], outs = kt.graph_replay(calls[key], n_graph)
        torch.cuda.synchronize()
        for out in outs:
            out = out if isinstance(out, tuple) else (out,)
            assert all(torch.equal(o, e) for o, e in zip(out, eager)), key
    emit({"phase": "graph_capture", "card": card, "launches_per_graph":
          n_graph, "equal_to_eager": True, "replay_ms_per_launch": replay_ms})

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
    step_ms = {job: cuda_ms(fn, 20 if job == "train" else 50,
                            warmup=3) for job, fn in steps.items()}
    emit({"phase": "step_times", "card": card, "ms": step_ms,
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
    t0 = time.perf_counter()
    prof = profiled(steps["train"], n_prof)
    wall_ms = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(prof)
    busy_ms = sum(us for _, us in kern.values()) / 1e3
    top_dev = sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]
    top_cpu = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total
                     )[:8]
    emit({"phase": "train_profile", "card": card, "steps": n_prof,
          "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms if kern else None,
          "device_kernels_per_step": sum(c for c, _ in kern.values())
          / n_prof,
          "fill_kernels_per_step": sum(c for k, (c, _) in kern.items()
                                       if "FillFunctor" in k) / n_prof,
          "top_device_ms": {k[:70]: us / 1e3 for k, (_, us) in top_dev},
          "top_host_self_ms": {e.key[:70]: e.self_cpu_time_total / 1e3
                               for e in top_cpu}})

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
    assert all(r["launches"] > 0 for r in rows), rows
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
