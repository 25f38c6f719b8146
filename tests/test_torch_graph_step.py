"""The port's steps as CUDA graphs capture them (Trainer._run), on the CPU.

- Capture safety: every aten op of the train, eval and HMC step bodies,
  logged with its non-tensor arguments and its tensors' shapes and dtypes,
  is the same sequence at two beta, two eps and two lr values, and holds no
  host read of a tensor (aten._local_scalar_dense, aten.is_nonzero): what
  a graph bakes in does not depend on them. U(1) with BN and dropout, and
  SU(3) with the flowed charge loss (one flow step).
- Draws made up front: a step whose draws `_step_draws` makes before it
  equals, bit for bit, the same step's body drawing inline from a
  generator of the same seed, and leaves the generator in the same state.
- The optimizer: the optax-form Adam on foreach ops against
  torch.optim.Adam, and checkpoints of either restoring into it.
- Op attribution at capture (utils/spans.py): the spans inside a captured
  U(1) train step, SU(3) eval step and SU(3) flow partition the graph's
  operations, nest as the step path does, and hold the stand-in graph's
  ops recorded inside each; the flow's graph, captured by `_run` after a
  shape's first, eager flow, shares the trainer's pool and is listed by
  graph_stats.
- On the card (`cuda` marker, skipped here): graphed steps bit-equal to
  eager ones across a beta, lr and eps change, one capture per key.

Runs without the JAX package:
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_graph_step.py
"""
import contextlib
import copy

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from l2hmc_torch.configs import get_config
from l2hmc_torch.train.optim import Adam
from l2hmc_torch.train.trainer import Trainer
from l2hmc_torch.utils import spans

torch.set_num_threads(1)

U1 = ["dynamics.nchains=4", "dynamics.latvolume=[4, 4]",
      "dynamics.nleapfrog=2", "network.units=[4]",
      "network.use_batch_norm=true", "network.dropout_prob=0.2",
      "learning_rate.clip_norm=1.0", "seed=3"]
SU3 = ["dynamics.nchains=2", "dynamics.latvolume=[2, 2, 2, 2]",
       "dynamics.nleapfrog=1", "network.units=[4]", "precision=float32",
       "loss.charge_weight=0.01", "loss.charge_flow_nsteps=1", "seed=5"]
CONFIGS = {
    "u1": (U1, "U1"),
    "u1_aux_single_direction": (U1 + ["loss.aux_weight=0.5",
                                      "dynamics.merge_directions=false"],
                                "U1"),
    "su3_flowed_loss": (SU3, "SU3"),
}


def _trainer(name, **kw):
    overrides, group = CONFIGS[name]
    return Trainer(get_config(overrides, group=group), device="cpu", **kw)


def _describe(a):
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), str(a.dtype))
    if isinstance(a, (list, tuple)):
        return tuple(_describe(b) for b in a)
    if isinstance(a, dict):
        return tuple(sorted((k, _describe(v)) for k, v in a.items()))
    if isinstance(a, (bool, int, float, complex, str, type(None),
                      torch.dtype, torch.device, torch.layout,
                      torch.memory_format)):
        return repr(a)
    return type(a).__name__       # e.g. the profiler's record handles


class OpLog(TorchDispatchMode):
    """Every aten op with its arguments: tensors by shape and dtype, the
    rest by value."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), _describe(args), _describe(kwargs)))
        return func(*args, **kwargs)


def _logged_bodies(name, beta, eps, lr):
    """The ops of one train, eval and HMC step body of a trainer warmed by
    one eager step (a graph's first step), at (beta, eps, lr), and the
    train loss and the eval and HMC x_out."""
    tr = _trainer(name)
    gen = torch.Generator().manual_seed(0)
    x = tr.random_x(gen)
    x, _ = tr.train_step(x, 3.0, gen)
    tr.set_lr(lr)
    logs, outs = {}, {}
    beta, eps = tr._scalar(beta), tr._scalar(eps)
    d = tr._step_draws("train", x, gen, None)
    with OpLog() as log:
        _, out = tr._train_body(x, beta, update=True, **d)
    logs["train"], outs["train"] = log.ops, float(out["loss"])
    with torch.no_grad():
        d = tr._step_draws("eval", x, gen, None)
        with OpLog() as log:
            xo, _ = tr._eval_body(x, beta, **d)
        logs["eval"], outs["eval"] = log.ops, xo.clone()
        d = tr._step_draws("hmc", x, gen, None)
        with OpLog() as log:
            xo, _ = tr._hmc_body(x, beta, eps, **d)
        logs["hmc"], outs["hmc"] = log.ops, xo.clone()
    return logs, outs


@pytest.mark.parametrize("name", ["u1", "su3_flowed_loss"])
def test_step_bodies_bake_in_no_beta_eps_or_lr(name):
    beta0, beta1 = (2.0, 3.5) if name == "u1" else (5.0, 6.0)
    logs0, outs0 = _logged_bodies(name, beta0, 0.1, 1e-3)
    logs1, outs1 = _logged_bodies(name, beta1, 0.05, 3e-4)
    for job in ("train", "eval", "hmc"):
        assert len(logs0[job]) > 50, job
        assert logs0[job] == logs1[job], job
        names = {op for op, _, _ in logs0[job]}
        assert not names & {"aten._local_scalar_dense.default",
                            "aten.is_nonzero.default"}, (job, names)
    # the values did reach the steps
    assert outs0["train"] != outs1["train"]
    assert not torch.equal(outs0["hmc"], outs1["hmc"])


def _equal(a, b):
    return torch.equal(a, b) or (a.shape == b.shape and torch.equal(
        torch.nan_to_num(a, nan=1.5), torch.nan_to_num(b, nan=1.5)))


@pytest.mark.parametrize("job", ["train", "eval", "hmc"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_draws_made_up_front_equal_inline_draws(name, job):
    up, inline = _trainer(name), _trainer(name)
    x = up.random_x(torch.Generator().manual_seed(0))
    g_up = torch.Generator().manual_seed(1)
    g_in = torch.Generator().manual_seed(1)
    beta, eps = (2.5, 0.1) if CONFIGS[name][1] == "U1" else (5.5, 0.05)
    if job == "train":
        xa, ma = up.train_step(x, beta, g_up)
        inline.set_lr(inline._scheduled_lr())
        xb, mb = inline._train_body(x, inline._scalar(beta), update=True,
                                    generator=g_in)
        for pa, pb in zip(up.dynamics.state_dict().values(),
                          inline.dynamics.state_dict().values()):
            assert torch.equal(pa, pb)
    else:
        with torch.no_grad():
            if job == "eval":
                xa, ma = up.eval_step(x, beta, g_up)
                xb, mb = inline._eval_body(x, inline._scalar(beta),
                                           generator=g_in)
            else:
                xa, ma = up.hmc_step(x, beta, eps, g_up)
                xb, mb = inline._hmc_body(x, inline._scalar(beta),
                                          inline._scalar(eps),
                                          generator=g_in)
    assert torch.equal(xa, xb)
    assert set(mb) <= set(ma)
    for k in mb:
        assert _equal(ma[k], mb[k]), k
    assert torch.equal(g_up.get_state(), g_in.get_state())


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=g,
                                           dtype=torch.float64))
            for s in ((3, 4), (5,), ())]


def _grads(params, step):
    g = torch.Generator().manual_seed(100 + step)
    for p in params:
        p.grad = torch.randn(p.shape, generator=g, dtype=p.dtype)


def test_adam_matches_torch_adam_and_reads_its_lr_scalar():
    ours, ref = _params(), _params()
    opt = Adam(ours, lr=1e-2)
    opt_ref = torch.optim.Adam(ref, lr=1e-2, eps=1e-8)
    for step in range(5):
        if step == 3:
            opt.set_lr(4e-3)
            opt_ref.param_groups[0]["lr"] = 4e-3
        _grads(ours, step)
        _grads(ref, step)
        opt.step()
        opt_ref.step()
    for p, q in zip(ours, ref):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-14)
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(opt.state[p][k], opt_ref.state[q][k],
                                       rtol=0, atol=1e-15)
    assert isinstance(opt.param_groups[0]["lr"], torch.Tensor)
    assert opt.lr == 4e-3 and float(opt.param_groups[0]["lr"]) == 4e-3


def test_adam_restores_its_own_and_torch_adam_checkpoints():
    ref = _params()
    opt_ref = torch.optim.Adam(ref, lr=2e-3, eps=1e-8)
    _grads(ref, 0)
    opt_ref.step()
    ours = _params()
    opt = Adam(ours, lr=1.0)
    opt.load_state_dict(copy.deepcopy(opt_ref.state_dict()))
    assert opt.lr == 2e-3
    assert isinstance(opt.param_groups[0]["lr"], torch.Tensor)
    for p, q in zip(ours, ref):
        st = opt.state[p]
        assert st["step"].dtype == p.dtype and float(st["step"]) == 1.0
        assert torch.equal(st["exp_avg"], opt_ref.state[q]["exp_avg"])
    sd = opt.state_dict()
    assert sd["param_groups"][0]["lr"] == 2e-3
    again = Adam(_params(), lr=1.0)
    again.load_state_dict(copy.deepcopy(sd))
    _grads(ours, 1)
    _grads(again.param_groups[0]["params"], 1)
    opt.step()
    again.step()
    for p, q in zip(ours, again.param_groups[0]["params"]):
        assert torch.equal(p, q)


def test_accumulation_window_restores_in_place():
    tr = _trainer("u1")
    tr.grad_accum_steps = 2
    gen = torch.Generator().manual_seed(0)
    x, _ = tr.train_step(tr.random_x(gen), 2.0, gen)
    bufs = tr._acc_grads
    saved = tr.accumulated_grads()
    assert saved is not None and tr.updates == 0
    tr.restore_accumulated_grads(None)
    assert tr._acc_grads is bufs and all(not b.any() for b in bufs)
    tr.restore_accumulated_grads(saved)
    assert tr._acc_grads is bufs
    assert all(torch.equal(b, s) for b, s in zip(bufs, saved))
    tr.train_step(x, 2.0, gen)
    assert tr.updates == 1 and tr.accumulated_grads() is None
    assert all(not b.any() for b in bufs)


class _Tape(TorchDispatchMode):
    """A CUDA graph's semantics on the CPU: "capture" records every aten
    op with the very tensors it read and wrote; "replay" runs the ops
    again on those tensors and writes each result into the tensor the
    capture produced (a view's result already lies there). A number that
    reached an op during the capture is replayed unchanged, as a graph's
    kernel argument would be."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out

    @staticmethod
    def _into(dst, src):
        if isinstance(dst, torch.Tensor):
            if src is not dst and (dst.untyped_storage().data_ptr()
                                   != src.untyped_storage().data_ptr()):
                dst.copy_(src)
        elif isinstance(dst, (list, tuple)):
            for d, s in zip(dst, src):
                _Tape._into(d, s)

    def replay(self):
        with torch.no_grad():
            for func, args, kwargs, out in self.ops:
                self._into(out, func(*args, **kwargs))


def _tape_nodes(tape):
    """spans.graph_nodes for a _Tape: every recorded op is one device
    operation of the graph."""
    return (lambda: len(tape.ops)), None


class _StandInCuda:
    """What Trainer._run and _capture use of torch.cuda, on the CPU: the
    graph is a _Tape, the streams do nothing, and a capture leaves the
    trainer's tensors as it found them (a capture runs no kernel). Each
    capture's tape and memory pool are kept in `captures`."""

    def __init__(self, trainer):
        self.tr = trainer
        self.captures = []
        self.Stream = lambda *a, **k: self
        self.current_stream = lambda *a, **k: self
        self.stream = lambda s: contextlib.nullcontext()
        self.graph_pool_handle = object
        self.memory_reserved = lambda *a, **k: 0
        self.empty_cache = lambda: None
        self.CUDAGraph = _Tape

    def wait_stream(self, other):
        pass

    def _state(self):
        tr = self.tr
        ts = list(tr.dynamics.state_dict(keep_vars=True).values())
        ts += [p.grad for p in tr.dynamics.parameters() if p.grad is not None]
        ts += [t for st in tr.optimizer.state.values() for t in st.values()]
        return ts + list(tr._acc_grads or [])

    @contextlib.contextmanager
    def graph(self, tape, pool=None):
        self.captures.append((tape, pool))
        saved = [(t, t.detach().clone()) for t in self._state()]
        with tape:
            yield
        with torch.no_grad():
            for t, v in saved:
                t.copy_(v)


@pytest.mark.parametrize("name", ["u1", "u1_aux_single_direction"])
def test_graph_cache_replays_equal_eager_steps(monkeypatch, name):
    """Trainer._run's cache with stand-in graphs (`_Tape`) against the
    eager steps, from one state and one seed: train steps across a beta
    and an lr change, two accumulation windows of 2 across a beta change,
    eval steps and HMC steps across an eps change. Bit-equal; one capture
    per key; every key's later steps replayed."""
    from l2hmc_torch.train import trainer as trainer_mod
    graphed, eager = _trainer(name), _trainer(name)
    graphed.use_graphs = True
    monkeypatch.setattr(trainer_mod.torch, "cuda", _StandInCuda(graphed))
    monkeypatch.setattr(spans, "graph_nodes", _tape_nodes)
    x0 = graphed.random_x(torch.Generator().manual_seed(0))
    res = {}
    for t in (graphed, eager):
        gen = torch.Generator().manual_seed(1)
        x, outs = x0.clone(), []
        for i, (beta, k) in enumerate([(2.0, 1), (2.0, 1), (2.5, 1),
                                       (2.5, 1), (2.5, 2), (2.5, 2),
                                       (2.0, 2), (2.0, 2), (2.5, 2),
                                       (2.5, 2)]):
            if i == 3:
                t.set_lr(4e-4)
            t.grad_accum_steps = k
            x, m = t.train_step(x, beta, gen)
            outs += [x, m["loss"], m["grad_norm"]]
        xe = x[:2].contiguous()
        for _ in range(3):
            xe, m = t.eval_step(xe, 2.5, gen)
            outs += [xe, m["acc"]]
        for eps in (0.1, 0.1, 0.1, 0.05):
            xe, m = t.hmc_step(xe, 2.5, eps, gen)
            outs += [xe, m["acc"]]
        res[t is graphed] = outs
    for a, b in zip(res[True], res[False]):
        assert torch.equal(a, b)
    for a, b in zip(graphed.dynamics.state_dict().values(),
                    eager.dynamics.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(graphed.dynamics.parameters(),
                    eager.dynamics.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(graphed.optimizer.state[p][key],
                               eager.optimizer.state[q][key])
    stats = graphed.graph_stats()
    keys = {(s["job"], s["grad_accum_steps"], s["flags"].get("update"))
            for s in stats}
    # with one direction drawn per pass (two passes with the aux loss) a
    # train key may come up once only, and never be captured
    want = {("eval", 1, None), ("hmc", 1, None)} | (
        {("train", 1, True), ("train", 2, False), ("train", 2, True)}
        if name == "u1" else set())
    assert want <= keys and any(k[0] == "train" for k in keys), keys
    assert all(s["replays"] >= 1 for s in stats)


class _PathTape(_Tape):
    """A _Tape that also records the span path open at each op (relative
    to the capture in progress)."""

    def __init__(self):
        super().__init__()
        self.paths = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        cap = spans._capture
        self.paths.append(cap.stack[-1][1] if cap is not None and cap.stack
                          else spans.NONE)
        return out


def _check_attribution(stats, tape, top, inner):
    """span_ops partitions the graph's ops among the top-level spans and
    "(none)"; each `inner` span lies under one of `top` and holds no more
    than it; every path holds exactly the tape's ops recorded inside it,
    and its ranges cover as many."""
    ops, span_ops = stats["ops"], stats["span_ops"]
    assert ops == len(tape.ops) > 0
    assert sum(v for p, v in span_ops.items() if "/" not in p) == ops
    assert {p for p in span_ops if "/" not in p} <= set(top) | {spans.NONE}
    for path, n in span_ops.items():
        names = path.split("/")
        assert all(nm in inner for nm in names[1:]), path
        if path == spans.NONE:
            want = tape.paths.count(spans.NONE)
        else:
            want = sum(1 for p in tape.paths
                       if p == path or p.startswith(path + "/"))
            assert n == sum(hi - lo for lo, hi in stats["span_ranges"][path])
            for lo, hi in stats["span_ranges"][path]:
                assert all(p == path or p.startswith(path + "/")
                           for p in tape.paths[lo:hi]), path
        assert n == want, (path, n, want)
        if len(names) > 1:
            assert n <= span_ops["/".join(names[:-1])], path


def _captured(monkeypatch, tr, job, nsteps):
    """Run nsteps steps of `job` through the stand-in graphs (the first
    eager, the second captured); the captured graph's stats and tape."""
    from l2hmc_torch.train import trainer as trainer_mod
    tr.use_graphs = True
    monkeypatch.setattr(trainer_mod.torch, "cuda", _StandInCuda(tr))
    monkeypatch.setattr(spans, "graph_nodes", _tape_nodes)
    tapes = []

    def new_tape():
        tapes.append(_PathTape())
        return tapes[-1]
    trainer_mod.torch.cuda.CUDAGraph = new_tape
    gen = torch.Generator().manual_seed(1)
    x = tr.random_x(gen)
    for _ in range(nsteps):
        if job == "train":
            x, _ = tr.train_step(x, 2.0, gen)
        else:
            x, _ = tr.eval_step(x, 5.5, gen)
    (stats,) = [s for s in tr.graph_stats() if s["job"] == job]
    return stats, tapes[0], x


@pytest.mark.parametrize("name,job", [("u1", "train"),
                                      ("su3_flowed_loss", "eval")])
def test_capture_attributes_every_op_to_its_span(monkeypatch, name, job):
    """A captured step's span_ops: the transition (networks, force), loss,
    backward, optimizer and metrics spans hold the graph's ops, and each
    holds the ops the stand-in graph recorded inside it."""
    stats, tape, _ = _captured(monkeypatch, _trainer(name), job, 3)
    # the captured step replays its graph too
    assert stats["replays"] == 2
    if job == "train":
        top = ("transition", "loss", "backward", "optimizer", "metrics")
    else:
        top = ("transition", "metrics")
    inner = ("networks", "u1.force", "su3.force_and_traces", "su3.expm",
             "su3.reunit")
    _check_attribution(stats, tape, top, inner)
    span_ops = stats["span_ops"]
    # outside the spans only views, which put nothing on the device
    assert {str(op[0]) for op, p in zip(tape.ops, tape.paths)
            if p == spans.NONE} <= {"aten.detach.default"}
    assert span_ops["transition/networks"] > 0
    if name == "u1":
        # every leapfrog step is recomputed in the backward pass
        assert span_ops["transition/u1.force"] > 0
        assert span_ops["backward/networks"] > 0
        assert span_ops["backward/u1.force"] > 0
        assert span_ops["backward"] > span_ops["backward/networks"]
    else:
        for op in ("force_and_traces", "expm", "reunit"):
            assert span_ops[f"transition/su3.{op}"] > 0
        assert not any(p.startswith("backward") for p in span_ops)


def test_flow_graph_is_listed_and_attributed(monkeypatch):
    """`_flow_metrics` runs a shape's first flow eagerly, then captures it
    through `_run` in the trainer's one pool, lists its graph in
    graph_stats under job "flow" with its capture, pool memory, replays
    and span operations, and its replay equals the eager flow."""
    tr = _trainer("su3_flowed_loss")
    tr.cfg.flow_nsteps = 1
    _, _, x = _captured(monkeypatch, tr, "eval", 2)
    from l2hmc_torch.train import trainer as trainer_mod
    cuda = trainer_mod.torch.cuda
    y = tr.random_x(torch.Generator().manual_seed(7), x.shape[0])
    first = tr._flow_metrics(y)
    assert not any(s["job"] == "flow" for s in tr.graph_stats())
    assert len(cuda.captures) == 1           # the eval step's only
    tr._flow_metrics(x)
    out = tr._flow_metrics(y)
    (flow,) = [s for s in tr.graph_stats() if s["job"] == "flow"]
    assert flow["replays"] == 2 and flow["shapes"] == {"x": list(x.shape)}
    assert flow["flags"] == {} and flow["pool_bytes_added"] == 0
    assert flow["capture_s"] > 0 and flow["instantiate_s"] >= 0
    (entry,) = [e for e in tr._graphs.values() if e.stats["job"] == "flow"]
    tape = entry.graph
    assert tr._pool is not None
    assert [p for t, p in cuda.captures] == [tr._pool, tr._pool]
    assert cuda.captures[1][0] is tape
    _check_attribution(flow, tape, ("flow",),
                       ("su3.force_and_traces", "su3.expm", "su3.reunit"))
    assert flow["span_ops"]["flow"] == flow["ops"]
    for op in ("force_and_traces", "expm", "reunit"):
        assert flow["span_ops"][f"flow/su3.{op}"] > 0
    want = tr._flow_observables(y)
    assert set(out) == set(want) == set(first)
    for k in want:
        assert torch.equal(out[k], want[k]), k
        assert torch.equal(first[k], want[k]), k


def test_the_cpu_runs_eagerly():
    assert not _trainer("u1").use_graphs
    assert not _trainer("u1", graphs=False).use_graphs


@pytest.mark.cuda
def test_cuda_graphed_steps_equal_eager_steps():
    """Two trainers from one state, one graphed and one eager, through
    train steps across a beta and an lr change, eval steps and HMC steps
    across an eps change: bit-equal, one capture per key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's graph_steps phase "
                    "runs this check at full width on the H100)")
    cfg = get_config(U1)
    tr = {g: Trainer(cfg, device="cuda", graphs=g) for g in (True, False)}
    tr[False].dynamics.load_state_dict(tr[True].dynamics.state_dict())
    x0 = tr[True].random_x(torch.Generator("cuda").manual_seed(0))
    res = {}
    for g, t in tr.items():
        gen = torch.Generator("cuda").manual_seed(1)
        x, outs = x0.clone(), []
        for i, beta in enumerate([2.0, 2.0, 2.0, 3.0, 3.0]):
            if i == 4:
                t.set_lr(5e-4)
            x, m = t.train_step(x, beta, gen)
            outs.append(m["loss"])
        xe = x[:2].contiguous()
        for _ in range(3):
            xe, m = t.eval_step(xe, 3.0, gen)
            outs.append(m["acc"])
        for eps in (0.1, 0.1, 0.1, 0.05):
            xe, m = t.hmc_step(xe, 3.0, eps, gen)
            outs.append(m["acc"])
        res[g] = (x, xe, outs, list(t.dynamics.state_dict().values()))
    for a, b in zip(res[True][2], res[False][2]):
        assert torch.equal(a, b)
    assert torch.equal(res[True][0], res[False][0])
    assert torch.equal(res[True][1], res[False][1])
    assert all(torch.equal(a, b) for a, b in zip(res[True][3],
                                                 res[False][3]))
    stats = tr[True].graph_stats()
    assert sorted(s["job"] for s in stats) == ["eval", "hmc", "train"]
    assert all(s["replays"] >= 2 for s in stats)


@pytest.mark.cuda
def test_cuda_flow_graph_equals_the_eager_flow_and_twin():
    """A flowed draw's Wilson flow on the card: eager at its shape's first
    call, then captured in the trainer's pool and replayed, bit-equal to
    the flow's body and to an eager twin's flow, which captures nothing;
    listed by graph_stats as job "flow" with its pool memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's su3_flow_graph "
                    "phase runs this check at 8^4 on the H100)")
    tr = Trainer(get_config(["flow_nsteps=2"], group="SU3"), device="cuda")
    twin = tr.twin(graphs=False)
    gen = torch.Generator("cuda").manual_seed(0)
    xs = [tr.random_x(gen) for _ in range(3)]
    outs = [tr._flow_metrics(x) for x in xs]
    (flow,) = [s for s in tr.graph_stats() if s["job"] == "flow"]
    assert flow["replays"] == 2 and flow["flags"] == {}
    assert flow["shapes"] == {"x": list(xs[0].shape)}
    assert flow["pool_bytes_added"] >= 0 and flow["ops"] > 0
    for x, out in zip(xs, outs):
        body = tr._flow_observables(x)
        eager = twin._flow_metrics(x)
        assert set(out) == set(body) == set(eager)
        for k in body:
            assert torch.equal(out[k], body[k]), k
            assert torch.equal(out[k], eager[k]), k
    assert twin.graph_stats() == []
