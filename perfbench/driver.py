"""Drive the program through one cell: build its trainer, hand it the
run's inputs, warm its steps up, then run the measured window through the
same public loop, with marks and records taken by wrappers around the
trainer instance's step methods.

The wrappers live here and change nothing in the program: each step gets
its draws from the run's seed (the steps' `draws` argument), and the
measured job's steps put a completion mark on the device's stream without
waiting for it. What the window's first steps (training) or a seeded
sample of its steps (drawing) took in and gave out is kept for the
comparison with the reference once the window has closed.
"""
from __future__ import annotations

import math
import random
import time
from typing import Optional

import torch
from torch.profiler import record_function

from perfbench import inputs, timing
from perfbench.trace import HARNESS_RANGE

#: training: the steps the reference follows
CHECKED_TRAIN_STEPS = 3
#: profiled steps: the window's steps before the stretch, and the
#: profiler's warm-up step
TRACE_WAIT, TRACE_WARMUP = 2, 1


def card_state() -> Optional[str]:
    """The card's SM clock, power draw and limit and temperature, as
    nvidia-smi reads them (None without it): beside every measurement,
    since a card may run below its power limit and clocks."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


class Run:
    """One run of a cell: `job` is "train", "eval" or "hmc"."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str, t0: float):
        self.cell = cell
        self.spec = cell.spec
        self.job = cell.traffic["job"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = trace
        self.device = torch.device(device)
        self.t0 = t0
        self.phase = "build"
        self.index = 0
        self.in_warmup = 0
        self.warmup_entered: Optional[float] = None
        self.marks = None
        self.prof = None
        self.sample: set = set()
        self.rec: dict = {"steps": [], "samples": {}, "therm": None}
        self.times: dict = {}

    # ------------------------------------------------------------------
    def build(self) -> None:
        from l2hmc_torch.experiment import build_experiment
        ex = build_experiment(list(self.cell.config["overrides"]),
                              group=self.spec["group"], device=str(self.device))
        self.experiment = ex
        tr = self.trainer = ex.trainer
        dyn = tr.dynamics
        named_p, named_b = inputs.layout(self.spec)
        if (named_p != [(n, tuple(p.shape)) for n, p in dyn.named_parameters()]
                or named_b != [(n, tuple(b.shape))
                               for n, b in dyn.named_buffers()]):
            raise ValueError("the program's parameters are not the ones the "
                             "configuration's reference block describes")
        params, bufs = inputs.make_state(
            named_p, named_b, self.spec, self.cell.config.get("weights", {}),
            inputs.generator(self.seed, 0, self.device), self.device)
        with torch.no_grad():
            for n, p in dyn.named_parameters():
                p.copy_(params[n])
            for n, b in dyn.named_buffers():
                b.copy_(bufs[n])
        self.init = (params, bufs)
        cfg = tr.cfg
        self.nchains = (cfg.dynamics.nchains if self.job == "train"
                        else cfg.nchains)
        self.x0 = inputs.start_links(self.spec, self.nchains,
                                     inputs.generator(self.seed, 1,
                                                      self.device),
                                     self.device, tr.dtype)
        self.gen_steps = inputs.generator(self.seed, 2, self.device)
        self.dropout_rows = (8 * self.spec["nleapfrog"]
                             if self.spec.get("dropout", 0) > 0 else 0)
        self._install()

    def _install(self) -> None:
        tr = self.trainer
        orig = {k: getattr(tr, k) for k in
                ("train_step", "eval_step", "hmc_step", "warmup")}

        def warmup(*a, **k):
            self.in_warmup += 1
            if self.warmup_entered is None:
                self.warmup_entered = time.perf_counter()
            try:
                return orig["warmup"](*a, **k)
            finally:
                self.in_warmup -= 1

        def train_step(x, beta, generator=None, draws=None):
            return self._step("train", orig["train_step"], x, beta, ())

        def eval_step(x, beta, generator=None, draws=None):
            return self._step("eval", orig["eval_step"], x, beta, ())

        def hmc_step(x, beta, eps, generator=None, draws=None):
            return self._step("hmc", orig["hmc_step"], x, beta, (eps,))

        tr.warmup, tr.train_step = warmup, train_step
        tr.eval_step, tr.hmc_step = eval_step, hmc_step
        if tr._flow_enabled:
            flow = tr._flow_metrics

            def flow_metrics(x):
                out = flow(x)
                self._after_flow(out)
                return out
            tr._flow_metrics = flow_metrics

    # ------------------------------------------------------------------
    def _step(self, kind, fn, x, beta, extra):
        is_job = kind == self.job and not (kind == "hmc" and self.in_warmup)
        rows = self.dropout_rows if kind == "train" else 0
        if self.prof is None:
            draws = inputs.step_draws(x, self.spec, self.gen_steps, rows)
        else:
            # the harness's own work in the window, named for the trace
            with record_function(HARNESS_RANGE):
                draws = inputs.step_draws(x, self.spec, self.gen_steps, rows)
        if is_job:
            self._before(self.index)
        xout, metrics = fn(x, beta, *extra, None, draws=draws)
        if is_job:
            self._after(self.index, x, beta, extra, draws, xout, metrics)
            self.index += 1
        elif (kind == "hmc" and self.phase == "warm"
              and self.rec["therm"] is None):
            # the first thermalization trajectory: the stage from the
            # start to the first step the reference follows
            self.rec["therm"] = {"x_in": x, "beta": beta, "eps": extra[0],
                                 "draws": draws, "x_out": xout,
                                 "acc": metrics["acc"]}
        return xout, metrics

    def _before(self, i: int) -> None:
        if self.phase != "window":
            return
        if i == 0:
            self._sync()
            now = time.perf_counter()
            self.times["setup_s"] = now - self.t0
            if self.warmup_entered is not None:
                self.times["thermalize_s"] = now - self.warmup_entered
            self.marks.mark_start()
            if self.prof is not None:
                self.prof.start()
        elif self.prof is not None:
            self.prof.step()

    def _after(self, i, x, beta, extra, draws, xout, metrics) -> None:
        if i < len(self.marks.ends):
            self.marks.mark(i)
        if self.phase == "warm" and self.job == "train" \
                and i < CHECKED_TRAIN_STEPS:
            self._record_train_step(i, x, beta, draws, xout, metrics)
        if self.phase == "window" and i in self.sample:
            self.rec["samples"][i] = {
                "x_in": x, "beta": beta, "eps": extra[0] if extra else None,
                "draws": draws, "x_out": xout, "metrics": metrics}

    def _record_train_step(self, i, x, beta, draws, xout, metrics) -> None:
        """A training step the reference follows, and the program's state
        after it (parameters; after the last, the batch-norm running
        statistics too; after the first, Adam's first moment, (1 - b1) g,
        or zeros if the step applied no update). Set-up time: copied to
        the host so that the records hold no card memory."""
        def host(t):
            return t.detach().to("cpu", copy=True)
        dyn = self.trainer.dynamics
        self.rec["steps"].append({
            "x_in": host(x), "beta": beta,
            "draws": {k: host(v) for k, v in draws.items()},
            "x_out": host(xout), "loss": host(metrics["loss"]),
            "acc": host(metrics["acc"]),
            "sumlogdet": host(metrics["sumlogdet"]),
            "params_out": {n: host(p) for n, p in dyn.named_parameters()}})
        if i == 0:
            state = self.trainer.optimizer.state
            self.rec["exp_avg1"] = {
                n: (host(state[p]["exp_avg"]) if "exp_avg" in
                    state.get(p, {}) else torch.zeros_like(host(p)))
                for n, p in dyn.named_parameters()}
        if i == CHECKED_TRAIN_STEPS - 1:
            self.rec["buffers_out"] = {
                n: host(b) for n, b in dyn.named_buffers()
                if n.endswith(("r_mean", "r_var"))}

    def _after_flow(self, out: dict) -> None:
        """A flowed draw ends with its flow: its completion mark moves
        there, and a sampled draw keeps the flowed observables."""
        i = self.index - 1
        if self.phase in ("warm", "window") and 0 <= i < len(
                self.marks.ends):
            self.marks.mark(i)
        if self.phase == "window" and i in self.rec["samples"]:
            self.rec["samples"][i]["flow"] = out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _new_marks(self, n: int):
        return (timing.CudaMarks(n) if self.device.type == "cuda"
                else timing.HostMarks(n))

    # ------------------------------------------------------------------
    def _loop(self, x, nsteps: int):
        """The cell's job as its users run it: the era/epoch loop, or the
        eval/HMC loop, for nsteps steps from x."""
        tr, t = self.trainer, self.cell.traffic
        gen = self.experiment.generator
        if self.job == "train":
            return tr.train(x, gen, nera=1, nepoch=nsteps)
        x, _ = tr.evaluate(gen, job_type=self.job, nsteps=nsteps, x=x,
                           eps=t.get("eps"),
                           dynamic_step_size=bool(t.get("dynamic_step_size",
                                                        False)))
        return x

    def warm(self) -> float:
        """Thermalize where the mix asks for it, then run the job's warm
        steps (the first eager, the second captured, the rest replayed)
        through the same loop; returns the mean seconds of the replayed
        steps between those the reference follows and the last, whose
        loop reads its metrics back."""
        t = self.cell.traffic
        first = CHECKED_TRAIN_STEPS if self.job == "train" else 2
        timed = int(t["timed_warm_steps"])
        nwarm = first + timed + 1
        self.phase = "warm"
        self.marks = self._new_marks(nwarm)
        x = self.x0
        if t.get("thermalize", 0) > 0:
            beta = self.trainer.schedule.beta_final
            x = self.trainer.warmup(x, beta, self.experiment.generator,
                                    nsteps=int(t["thermalize"]), exact=True)
        self.index = 0
        self.marks.mark_start()
        self.x = self._loop(x, nwarm)
        _, ends = self.marks.read(nwarm)
        return (ends[nwarm - 2] - ends[first - 1]) / 1e3 / timed

    def window(self, step_s: float) -> dict:
        """The measured window: as many steps as fill `seconds` at the
        warm steps' pace, and enough to hold the traced stretch."""
        t = self.cell.traffic
        ktrace = max(1, round(float(t["trace_seconds"]) / step_s))
        nsteps = max(math.ceil(self.seconds / step_s),
                     TRACE_WAIT + TRACE_WARMUP + ktrace + 2)
        if self.job != "train":
            k = min(int(t["check_steps"]), nsteps)
            self.sample = set(random.Random(self.seed).sample(range(nsteps),
                                                              k))
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, schedule
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(
                activities=acts,
                schedule=schedule(wait=TRACE_WAIT, warmup=TRACE_WARMUP,
                                  active=ktrace, repeat=1))
        self.ktrace = ktrace
        self.phase = "window"
        self.marks = self._new_marks(nsteps)
        self.index = 0
        self.warmup_entered = None
        self.times["card_before"] = card_state()
        self.x = self._loop(self.x, nsteps)
        start, ends = self.marks.read(nsteps)
        self.times["card_after"] = card_state()
        self.phase = "done"
        if self.prof is not None:
            self.prof.stop()
        return timing.window(start, ends)

    def release(self) -> None:
        """Drop the program and its graphs, keeping the records."""
        self.graph_stats = self.trainer.graph_stats()
        self.trainer = self.experiment = None
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
