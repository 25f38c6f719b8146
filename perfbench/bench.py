"""One run of one cell, as data: `BENCHMARK.json` names the cell, the
cell names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<mix>.json`), its limits sit in `limits/<cell>.json`, and each
per-layer metric is read by `metrics/<metric>.py`. Adding any of them is
adding files and entries; nothing here names a cell.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "l2hmc_tpu")
GIB = 2 ** 30


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    control: str
    spec: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, rehearsal: bool = False) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files; with
    `rehearsal`, cut to the configuration's CPU rehearsal size."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / confs[w["config"]]["file"])
    here = root / HERE.name
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    judged = _json(here / "limits" / f"{name}.json")
    spec = copy.deepcopy(config["reference"])
    if rehearsal:
        small = config["rehearsal"]
        config = dict(config, overrides=[*config["overrides"],
                                         *small["overrides"]])
        spec.update(small["reference"])
        traffic = {**traffic, **small.get("traffic", {})}
    return Cell(name, int(w["chips"]), config, traffic, judged["limits"],
                judged["control"], spec,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The `read(ctx)` of metrics/<metric>.py."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def end_to_end(run, win: dict, peak_bytes: Optional[int]) -> dict:
    """Every end-to-end quantity this run measured, by name."""
    from perfbench import timing
    nsteps = len(win["intervals_ms"])
    evals = run.nchains * 2 * run.spec["nleapfrog"]
    key = "train_evals_per_s" if run.job == "train" else "draw_evals_per_s"
    out = {"setup_s": run.times["setup_s"],
           key: timing.rate(evals, nsteps, win["seconds"])}
    if timing.tail_ok(nsteps, 95):
        out["step_p95_ms"] = timing.percentile(win["intervals_ms"], 95)
    if peak_bytes is not None:
        out["peak_mem_gib"] = peak_bytes / GIB
    return out


def card_metrics(cell: Cell, run, win: dict, peak: Optional[int],
                 red: Optional[dict]) -> dict:
    """The cell's end-to-end metrics (untraced run, `red` None) or its
    per-layer ones (traced run), each as {"value", "unit"}. A CPU
    rehearsal has none: it measures nothing of the card."""
    from perfbench import flops
    metrics = {}
    if red is None:
        values = end_to_end(run, win, peak)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        return metrics
    ctx = {"job": run.job, "kind": "train" if run.job == "train" else "draw",
           "trace": red, "traced_steps": run.ktrace,
           "graph_stats": run.graph_stats, "spec": run.spec,
           "nchains": run.nchains,
           "step_ops": flops.step_ops(run.spec, run.nchains, run.job)}
    for m in cell.per_layer:
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str, t0: float) -> dict:
    """Run the cell once and return its result: the contract's keys (the
    numbers judged under `checks`), and for the caller `_unjudged` (the
    comparison's other numbers), `_forbidden` and `_times`."""
    import torch
    from perfbench import check, driver
    from perfbench import trace as tr
    run = driver.Run(cell, seed, seconds, trace, device, t0)
    run.build()
    step_s = run.warm()
    win = run.window(step_s)
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_reserved(run.device) if cuda else None
    bad = forbidden_modules()
    red = None
    if trace:
        t = time.perf_counter()
        evs = tr.records(run.prof.profiler.kineto_results.events())
        red = tr.reduce(evs)
        h = red["harness"]
        run.times.update(trace_events=len(evs),
                         trace_read_s=time.perf_counter() - t,
                         harness_ms_per_step=1e3 * h["host_s"] / max(
                             1, h["ranges"]),
                         harness_launches_per_step=h["launches"] / max(
                             1, h["ranges"]))
    run.release()
    accs = [s["acc"] for s in run.rec["steps"]] + [
        s["metrics"]["acc"] for s in run.rec["samples"].values()]
    if accs:
        run.times["acc_checked"] = float(torch.cat(
            [a.flatten().double().cpu() for a in accs]).mean())
    t_check = time.perf_counter()
    if run.job == "train":
        numbers = check.train_numbers(run.rec, run.init, run.spec)
    else:
        numbers = check.draw_numbers(run.rec, run.init, run.spec, run.job)
    run.times["worst_leaf"] = numbers.pop("_worst", {})
    correct, rows = check.judge(numbers, cell.limits)
    metrics = card_metrics(cell, run, win, peak, red) if cuda else {}
    result = {"correct": bool(correct and not bad),
              "attempted": len(win["intervals_ms"]),
              "failed": sum(1 for _, v, lim in rows if not v <= lim),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(run.device)
                                  if cuda else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": peak}}
    if trace:
        result["device"]["busy_s"] = red["busy_s"]
        result["device"]["window_s"] = red["window_s"]
        result["breakdown"] = tr.breakdown(red)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    result["_forbidden"] = bad
    result["_unjudged"] = {k: v for k, v in numbers.items()
                           if k not in cell.limits}
    run.times["check_s"] = time.perf_counter() - t_check
    result["_times"] = dict(run.times, window_s=win["seconds"],
                            steps=len(win["intervals_ms"]),
                            warm_step_s=step_s)
    return result
