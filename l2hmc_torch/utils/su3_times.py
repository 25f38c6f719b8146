"""Times of the SU(3) engine's hot ops on one CUDA card, beside their
bounds, and their calls per training step.

    python -m l2hmc_torch.utils.su3_times

None of these ops has a hand-written kernel: they are the eager PyTorch
component engine (ops/su3_comp.py, ops/wilson_flow.py), ~22 device kernels
per 3x3 product. For each op at the shapes of one configuration (by
default the 8^4, 8-chain, float32 one that `chip_smoke.py` drives) a row
holds

  device_ms   torch.profiler's device time of one forward call;
  events_ms   CUDA events around back-to-back calls (host enqueue included);
  kernels     device kernels one call launches;
  bytes       what the op must move: each input read once, each output
              written once;
  bound_ms    bytes over the card's memory rate, or its 3x3 products'
              operations (216 per product and link) over the float32 or
              float64 rate, whichever is larger;
  calls_per_train_step
              forward calls counted while one real train step runs
              (recomputation under checkpoint included; backward passes
              are autograd's and are not calls);
  device_ms_per_train_step = device_ms * calls_per_train_step: the
              forward share only.

The U(1) NCP x-update (the elementwise part of `Dynamics._update_x_u1`,
its network call replaced by fixed s, t, q) is timed the same way at the
default U(1) shape. `chip_smoke.py` calls `hot_ops` and `u1_ncp_row`.

`main` also times the configuration's train step both ways, replayed from
its CUDA graph and eagerly (an eager twin of the same state), with the
graphs' capture and instantiation seconds and pool memory.
"""
from __future__ import annotations

import contextlib
import json
import math
import sys

import torch

from l2hmc_torch.models.dynamics import State
from l2hmc_torch.ops import su3_comp as comp
from l2hmc_torch.ops import wilson_flow as wf
from l2hmc_torch.utils import kernel_times as kt

#: real operations of one complex 3x3 product per link: 27 complex
#: multiply-adds of 8 real operations
OPS_PER_MM = 216
#: 3x3 products per call: force_and_traces 7 per plane on one direction's
#: links; expm(order 8, s 2) 7 + 2 and reunit 1 + 3*3 + 1 on all four
MM_FORCE, MM_EXPM, MM_REUNIT = 6 * 7, 9 * 4, 11 * 4
COUNTED = ("mm", "force_and_traces", "expm", "reunit", "topo_charge_clover")


@contextlib.contextmanager
def counting():
    """Count the calls of the engine's hot ops (and wilson_flow.flow_step)
    made inside the block: yields the dict of counts."""
    counts = {name: 0 for name in COUNTED + ("flow_step",)}
    saved = {}

    def wrap(mod, name):
        fn = getattr(mod, name)
        saved[(mod, name)] = fn

        def counted(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        setattr(mod, name, counted)

    for name in COUNTED:
        wrap(comp, name)
    wrap(wf, "flow_step")
    try:
        yield counts
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def _device(fn, reps: int) -> tuple:
    """(device ms, device kernels) per call of fn, from the profiler's raw
    events (a flow step is ~10^4 events a call)."""
    for _ in range(3):
        # the profiler now and then drops records (a count that is no
        # multiple of reps): such a window is taken again, and the last
        # one's dropped records take no time from the call (`per_call`)
        kern = kt.raw_summary(kt.profiled(fn, reps))["kernels"]
        count = sum(c for c, _ in kern.values())
        if count and count % reps == 0:
            break
    got = kt.per_call(kern, reps)
    return got["device_ms_per_call"], got["kernels_per_call"]


def _row(fn, nbytes: int, ops: float, rdtype, reps: int, calls) -> dict:
    by_bytes = nbytes / kt.HBM_BYTES_PER_S * 1e3
    by_ops = ops / kt.PEAK_OPS_PER_S[str(rdtype).replace("torch.", "")] * 1e3
    device_ms, kernels = _device(fn, reps)
    return {"device_ms": device_ms, "kernels": kernels,
            "events_ms": kt.cuda_ms(fn, reps, warmup=2),
            "bytes": nbytes, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "calls_per_train_step": calls,
            "device_ms_per_train_step": device_ms * calls}


def hot_ops(lat, nb: int, rdtype, counts: dict, reps: int = 10,
            device="cuda", seed: int = 0) -> dict:
    """One row per hot op at (lat, nb, rdtype); `counts` are the calls of
    one train step (from `counting`)."""
    lat = tuple(lat)
    n = math.prod(lat) * nb                 # links of one direction
    size = torch.empty((), dtype=rdtype).element_size()
    field = 18 * size                       # bytes of one link's matrix
    gen = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        v = comp.random_momentum(4 * n, gen, rdtype, device)
        x = comp.expm(comp.scale(v, 0.3))   # links on the group
        xu, vu = comp.dir_slice(x, 0, n), comp.dir_slice(v, 1, n)
        ops = {
            "mm": (lambda: comp.mm(xu, vu), 3 * field * n, n),
            "force_and_traces": (
                lambda: comp.force_and_traces(x, 2.0, lat, nb),
                2 * field * 4 * n + nb * size, MM_FORCE * n),
            "expm": (lambda: comp.expm(v, order=8, s=2),
                     2 * field * 4 * n, MM_EXPM * n),
            "update_gauge": (lambda: comp.update_gauge(x, v),
                             3 * field * 4 * n, (13 + 1) * 4 * n),
            "reunit": (lambda: comp.reunit(x), 2 * field * 4 * n,
                       MM_REUNIT * n),
            "flow_step": (
                lambda: wf.flow_step(x, 0.1, lat, nb),
                2 * field * 4 * n + nb * size,
                (3 * MM_FORCE + 3 * MM_EXPM + 3 * 4 + MM_REUNIT) * n),
        }
        calls = dict(counts)
        # update_gauge runs in plain HMC only, never in a train step
        calls["update_gauge"] = 0
        return {name: _row(fn, nbytes, OPS_PER_MM * links, rdtype, reps,
                           calls[name])
                for name, (fn, nbytes, links) in ops.items()}


def u1_ncp_row(dyn, nb: int, reps: int = 50, calls: int = 0) -> dict:
    """The U(1) NCP x-update's elementwise part at the dynamics' shape:
    reads x, v, s, t, q and the mask, writes x' and the logdet."""
    dev, rdt = dyn.xeps.device, dyn.real_dtype
    gen = torch.Generator(dev).manual_seed(0)
    xdim = dyn.xdim
    x, v, s, t, q = ((torch.rand((nb, xdim), generator=gen, device=dev,
                                 dtype=rdt) - 0.5) for _ in range(5))
    size = x.element_size()
    saved = dyn._call_xnet
    dyn._call_xnet = lambda *a, **k: (s, t, q)
    try:
        with torch.no_grad():
            eps = torch.sigmoid(dyn.xeps[0])

            def update():
                return dyn._update_x_u1(None, State(x, v, 1.0), dyn.masks[0],
                                        eps, +1, False, None)
            nbytes = (6 * nb * xdim + xdim + nb) * size
            # ~30 operations per link (tan, atan, exp x2, cos, sin, log)
            return _row(update, nbytes, 30 * nb * xdim, rdt, reps, calls)
    finally:
        dyn._call_xnet = saved


#: the 8^4 flowed-loss configuration of records/run_su3_flowloss.py,
#: without its step counts
MAIN_SU3 = [
    "dynamics.latvolume=[8, 8, 8, 8]", "dynamics.nchains=8", "nchains=8",
    "dynamics.nleapfrog=4", "dynamics.eps=0.02", "dynamics.eps_hmc=0.02",
    "dynamics.cold_start=true", "network.units=[32, 32]",
    "network.zero_init_heads=true", "network.use_batch_norm=false",
    "network.dropout_prob=0.0", "learning_rate.lr_init=1e-4",
    "learning_rate.clip_norm=1.0", "annealing_schedule.beta_init=5.2",
    "annealing_schedule.beta_final=5.7", "flow_nsteps=12", "flow_eps=0.1",
    "precision=float32", "save=false", "loss.use_mixed_loss=true",
    "loss.charge_weight=0.01", "loss.charge_flow_nsteps=12",
    "loss.charge_flow_eps=0.1",
]


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("su3_times: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from l2hmc_torch.experiment import build_experiment
    card = kt.card_line()
    ex = build_experiment(MAIN_SU3 + ["steps.nera=1", "steps.nepoch=1",
                                      "steps.test=1"], group="SU3")
    tr = ex.trainer
    # a fixed budget: from the ordered start the stationarity criterion
    # stops at once (every proposal is rejected, the plaquette stands)
    x = tr.warmup(ex.setup(), 5.7, ex.generator, nsteps=100, exact=True)
    eager = tr.twin(graphs=False)
    for _ in range(2):           # the graph: an eager first step, a capture
        tr.train_step(x, 5.7, ex.generator)
    with counting() as counts:   # an eager step calls every op
        eager.train_step(x, 5.7, ex.generator)
    step_ms = {"graphed": kt.cuda_ms(
        lambda: tr.train_step(x, 5.7, ex.generator), 3, warmup=0),
        "eager": kt.cuda_ms(lambda: eager.train_step(x, 5.7, ex.generator),
                            2, warmup=0)}
    cfg = ex.cfg.dynamics
    rows = hot_ops(cfg.latvolume, cfg.nchains, tr.dynamics.real_dtype, counts)
    print(json.dumps({"card": card, "config": "8^4 x 8 float32, flowed loss",
                      "train_step_ms": step_ms, "graphs": tr.graph_stats(),
                      "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                      "calls_per_train_step": counts, "hot_ops": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
