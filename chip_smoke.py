#!/usr/bin/env python3
"""Smoke run of the PyTorch port (l2hmc_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from l2hmc_torch/csrc/ (nvcc, -Xptxas -v);
  3. hold each kernel against its plain PyTorch version on the card, at
     the main-path shape (2048 x 2x16x16, float32 and float64), a ragged
     one (37 x 2x8x12) and the 64x64 lattice; gradcheck the
     autograd.Function at float64;
  4. the main path: `build_experiment(...).run()` at the default U(1)
     width (2048 chains, 16x16, nleapfrog 8, units [16]*4, BatchNorm and
     dropout on) for one era of 20 train steps, then 20 eval and 20 HMC
     draws, with the kernels' launch counters set to 0 just before and
     read just after; then one train, eval and HMC step each, counted
     alone against the launches expected per step;
  5. times, with CUDA events after warmup: each kernel and its plain
     version at the main-path shape, a train, an eval and an HMC step;
     the device's busy share over a few train steps (torch.profiler).
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
import subprocess
import sys
import tempfile
import time

#: H100 SXM data sheet: HBM rate, float32 and float64 rates outside the
#: tensor cores (dense), at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
#: operations per lattice site (sin and cos counted one each): forward
#: W (3), sin, cos, 1 - cos, the action sum, 2 subs + 2 muls of the force;
#: backward W (3), A gF (3), cos, the product, 2 subs, 2 muls, 2 fmas
FWD_OPS_PER_SITE, BWD_OPS_PER_SITE = 11, 15

ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def replaces(func: str) -> str:
    """file:line of the TPU kernel function in the JAX package."""
    (path,) = glob.glob(os.path.join(ROOT, "*", "ops", "pallas",
                                     "u1_kernels.py"))
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if line.startswith(f"def {func}("):
                return f"{os.path.relpath(path, ROOT)}:{n}"
    raise RuntimeError(f"{func} not found in {path}")


def cuda_ms(torch, fn, reps: int, warmup: int = 5) -> float:
    """Mean device time of fn over reps, between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(torch, fn, reps: int):
    """torch.profiler over reps calls of fn (after one warm call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def device_kernels(torch, prof) -> dict:
    """{kernel name: (count, device us)} of the profiled window."""
    from torch.autograd import DeviceType
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


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
    for nb, nt, nx, dtype in [(2048, 16, 16, torch.float32),
                              (2048, 16, 16, torch.float64),
                              (37, 8, 12, torch.float32),
                              (64, 64, 64, torch.float32),
                              (64, 64, 64, torch.float64)]:
        f32 = dtype == torch.float32
        x = (torch.rand((nb, 2 * nt * nx), generator=gen, device=dev,
                        dtype=dtype) * 2 - 1) * math.pi
        f, a = uk.force_action(x, beta, nt, nx)
        fp, ap = uk.force_action_plain(x, beta, nt, nx)
        gf = torch.randn(x.shape, generator=gen, device=dev, dtype=dtype)
        gs = torch.randn((nb,), generator=gen, device=dev, dtype=dtype)
        b = uk.force_action_bwd(x, gf, gs, f, beta, nt, nx)
        bp = uk.force_action_bwd_plain(x, gf, gs, f, beta, nt, nx)
        torch.cuda.synchronize()
        # force: atol 2e-5 (f32, as the Pallas kernel is held) / 1e-12
        # (f64); action: rtol 2e-5 / 1e-12; backward (values up to ~30 at
        # beta 4): atol 1e-4 / 1e-10
        torch.testing.assert_close(f, fp, atol=2e-5 if f32 else 1e-12,
                                   rtol=0)
        torch.testing.assert_close(a, ap, atol=0, rtol=2e-5 if f32 else 1e-12)
        torch.testing.assert_close(b, bp, atol=1e-4 if f32 else 1e-10,
                                   rtol=0)
        err = {"fwd": float((f - fp).abs().max()),
               "act_rel": float(((a - ap).abs() / ap.abs()).max()),
               "bwd": float((b - bp).abs().max())}
        errs[(nb, nt, nx, str(dtype))] = err
        emit({"phase": "compare", "shape": [nb, 2 * nt * nx], "nt": nt,
              "nx": nx, "dtype": str(dtype).replace("torch.", ""),
              "max_abs_err": err})
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

    # -- 5. times -------------------------------------------------------------
    nb, nt, nx = cfg.dynamics.nchains, *cfg.dynamics.latvolume
    xk = (torch.rand((nb, 2 * nt * nx), generator=gen, device=dev) * 2 - 1) \
        * math.pi
    fk, _ = uk.force_action(xk, beta, nt, nx)
    gk = torch.randn(xk.shape, generator=gen, device=dev)
    gsk = torch.randn((nb,), generator=gen, device=dev)
    reps = 200
    t = {
        "fwd_plain": cuda_ms(torch, lambda: uk.force_action_plain(
            xk, beta, nt, nx), reps),
        "fwd": cuda_ms(torch, lambda: uk.force_action(xk, beta, nt, nx), reps),
        "bwd": cuda_ms(torch, lambda: uk.force_action_bwd(
            xk, gk, gsk, fk, beta, nt, nx), reps),
        "bwd_plain": cuda_ms(torch, lambda: uk.force_action_bwd_plain(
            xk, gk, gsk, fk, beta, nt, nx), reps),
    }
    emit({"phase": "kernel_times", "card": card, "shape": [nb, 2 * nt * nx],
          "dtype": "float32", "reps": reps, "ms": t})
    step_ms = {job: cuda_ms(torch, fn, 20 if job == "train" else 50,
                            warmup=3) for job, fn in steps.items()}
    emit({"phase": "step_times", "card": card, "ms": step_ms,
          "nchains": {"train": nb, "eval": int(xe.shape[0]),
                      "hmc": int(xe.shape[0])}})

    # device time of the kernels alone (the event times above include
    # whatever the host's enqueue rate imposes), and the train step's
    # device busy share, kernels per step and host hot spots
    k_reps = 50
    kernel_dev_ms = {}
    for key, fn in [
            ("fwd", lambda: uk.force_action(xk, beta, nt, nx)),
            ("fwd_plain", lambda: uk.force_action_plain(xk, beta, nt, nx)),
            ("bwd", lambda: uk.force_action_bwd(xk, gk, gsk, fk, beta, nt,
                                                nx)),
            ("bwd_plain", lambda: uk.force_action_bwd_plain(
                xk, gk, gsk, fk, beta, nt, nx))]:
        prof = profiled(torch, fn, k_reps)
        kernel_dev_ms[key] = {
            "device_ms_per_call": sum(us for _, us in
                                      device_kernels(torch, prof).values())
            / k_reps / 1e3,
            "kernels_per_call": sum(c for c, _ in
                                    device_kernels(torch, prof).values())
            / k_reps}
    emit({"phase": "kernel_device_times", "card": card, "reps": k_reps,
          "shape": [nb, 2 * nt * nx], "dtype": "float32",
          "profiler": kernel_dev_ms})

    n_prof = 3
    t0 = time.perf_counter()
    prof = profiled(torch, steps["train"], n_prof)
    wall_ms = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(torch, prof)
    busy_ms = sum(us for _, us in kern.values()) / 1e3
    top_dev = sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]
    top_cpu = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total
                     )[:8]
    emit({"phase": "train_profile", "card": card, "steps": n_prof,
          "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms if kern else None,
          "device_kernels_per_step": sum(c for c, _ in kern.values())
          / n_prof,
          "top_device_ms": {k[:70]: us / 1e3 for k, (_, us) in top_dev},
          "top_host_self_ms": {e.key[:70]: e.self_cpu_time_total / 1e3
                               for e in top_cpu}})

    # -- the kernels line -----------------------------------------------------
    sz = 4
    sites = nb * nt * nx
    bytes_fwd = nb * 2 * nt * nx * sz * 2 + nb * sz
    bytes_bwd = nb * 2 * nt * nx * sz * 4 + nb * sz
    err = errs[(nb, nt, nx, str(torch.float32))]

    def bound(nbytes, ops):
        b = nbytes / HBM_BYTES_PER_S * 1e3
        o = ops / PEAK_OPS_PER_S["float32"] * 1e3
        return max(b, o), "bytes" if b >= o else "operations"

    rows = []
    for name, key, nbytes, ops, func, e in [
            ("u1_force_fwd", "fwd", bytes_fwd, FWD_OPS_PER_SITE * sites,
             "_kernel", err["fwd"]),
            ("u1_force_bwd", "bwd", bytes_bwd, BWD_OPS_PER_SITE * sites,
             "_fa_bwd", err["bwd"])]:
        b_ms, b_by = bound(nbytes, ops)
        rows.append({
            "name": name, "route": "cuda",
            "source": "l2hmc_torch/csrc/u1_force.cu",
            "replaces": replaces(func), "launches": launches[name],
            "max_abs_err": e, "ms": t[key], "plain_ms": t[key + "_plain"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    assert all(r["launches"] > 0 for r in rows), rows
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
