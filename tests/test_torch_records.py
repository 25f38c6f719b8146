"""The port's record drivers (l2hmc_torch/records/) against the JAX
package's: the same overrides, the same summary keys, the same HMC
protocols; the standard errors and `compare` on data of known variance;
tiny runs on the CPU that write only under their output directory.

The JAX drivers are parsed with `ast`, never imported or run: the
flagship driver writes over the committed record."""
import ast
import hashlib
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from l2hmc_torch import configs as tcfg
from l2hmc_torch.experiment import Experiment
from l2hmc_torch.records import quality as q
from l2hmc_torch.records import run_su3_flowloss as fw
from l2hmc_torch.records import run_u1_flagship as fl
from l2hmc_torch.train.trainer import Trainer
from l2hmc_torch.utils.history import History
from l2hmc_tpu import configs as jcfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = os.path.join(ROOT, "records")
FLAGSHIP_RECORD = os.path.join(RECORDS, "u1_16x16_quality_summary.json")
PORT_RECORDS = os.path.join(ROOT, "l2hmc_torch", "records", "h100")

TINY_U1 = ["dynamics.nchains=16", "dynamics.latvolume=[8, 8]", "nchains=8",
           "steps.nepoch=3", "steps.test=8"]
TINY_SU3 = ["dynamics.latvolume=[2, 2, 2, 2]", "dynamics.nchains=2",
            "nchains=2", "network.units=[4]", "dynamics.nleapfrog=1",
            "flow_nsteps=2", "loss.charge_flow_nsteps=2"]


def _jax_overrides(path: str) -> list[str]:
    """The `overrides = [...]` list of a JAX record driver's main(), the
    f-strings filled from main()'s defaults, outdir left out."""
    tree = ast.parse(open(path).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = [a.arg for a in main.args.args]
    defaults = dict(zip(names[len(names) - len(main.args.defaults):],
                        [ast.literal_eval(d) for d in main.args.defaults]))
    assign = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "overrides")
    out = []
    for elt in assign.value.elts:
        if isinstance(elt, ast.Constant):
            out.append(elt.value)
            continue
        parts = []
        for v in elt.values:
            if isinstance(v, ast.Constant):
                parts.append(v.value)
            else:               # f"{int(name)}" or f"{name}"
                e = v.value
                if isinstance(e, ast.Call):
                    parts.append(str(int(defaults[e.args[0].id])))
                else:
                    parts.append(str(defaults[e.id]))
        s = "".join(parts)
        if not s.startswith("outdir="):
            out.append(s)
    return out


def _md_command(name: str) -> list[str]:
    """The override tokens of the `python -m l2hmc_tpu` command in a
    record's .md file."""
    text = open(os.path.join(RECORDS, name)).read()
    m = re.search(r"python -m l2hmc_tpu (.*?)\n\n", text, re.S)
    return m.group(1).replace("\\\n", " ").split()


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _numbers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield tree


@pytest.mark.parametrize("driver,port", [
    ("run_u1_flagship.py", fl.OVERRIDES),
    ("run_su3_flowloss.py", fw.OVERRIDES)], ids=["u1_flagship", "flowloss"])
def test_overrides_equal_jax_driver(driver, port):
    jax_list = _jax_overrides(os.path.join(RECORDS, driver))
    assert port == jax_list
    group = "SU3" if "su3" in driver else "U1"
    assert (tcfg.get_config(port, group=group).to_dict()
            == jcfg.get_config(jax_list, group=group).to_dict())


@pytest.mark.parametrize("name,md", [
    ("u1_64x64_bf16", "u1_64x64_bf16_quality.md"),
    ("su3_4x4_b6", "su3_4x4_b6_quality.md"),
    ("su3_8x8_b57", "su3_8x8_b57_quality.md")])
def test_companion_overrides_equal_command(name, md):
    assert q.RECORDS[name] == _md_command(md)
    group = q.RECORDS[name][0].split("=")[1]
    assert (tcfg.get_config(q.RECORDS[name], group=group).to_dict()
            == jcfg.get_config(q.RECORDS[name], group=group).to_dict())


@pytest.mark.parametrize("name", ["su3_4x4_b6", "su3_8x8_b57"])
def test_frozen_command_is_its_record_with_lr_0(name):
    """`*_frozen` is its record's command plus lr 0 and nothing else, in
    both packages' configs; lr 0 stays 0 under either package's
    ReduceLROnPlateau over the record's eras (one update an era, the
    loss never improving), and no schedule of the port reads more."""
    frozen = q.RECORDS[f"{name}_frozen"]
    assert frozen == q.RECORDS[name] + ["learning_rate.lr_init=0"]
    for cfgs in (tcfg, jcfg):
        want = cfgs.get_config(q.RECORDS[name], group="SU3").to_dict()
        got = cfgs.get_config(frozen, group="SU3").to_dict()
        assert got["learning_rate"].pop("lr_init") == 0
        assert want["learning_rate"].pop("lr_init") == 1e-4
        assert got == want
    from l2hmc_torch.train.annealing import ReduceLROnPlateau as TPlateau
    from l2hmc_tpu.train.annealing import ReduceLROnPlateau as JPlateau
    cfg = tcfg.get_config(frozen, group="SU3")
    assert cfg.learning_rate.schedule == "default"
    assert cfg.learning_rate.warmup == 0
    for plateau in (TPlateau(cfg.learning_rate),
                    JPlateau(jcfg.get_config(frozen,
                                             group="SU3").learning_rate)):
        assert [plateau.update(-1.0) for _ in range(cfg.steps.nera)] \
            == [0.0] * cfg.steps.nera


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """One tiny flagship run on the CPU (8x8, 16 train chains, 8 eval
    chains, 3 train steps, 8 draws), with every Trainer.evaluate call
    recorded."""
    calls = []
    plain_evaluate = Trainer.evaluate

    def evaluate(self, *args, **kw):
        calls.append(dict(kw))
        return plain_evaluate(self, *args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(Trainer, "evaluate", evaluate)
    mp.setattr(Experiment, "make_plots", lambda self: None)
    before = _sha(FLAGSHIP_RECORD)
    out = tmp_path_factory.mktemp("flagship")
    try:
        summary = fl.main(str(out), extra=TINY_U1, device="cpu")
    finally:
        mp.undo()
    return {"summary": summary, "calls": calls, "out": out,
            "sha": (before, _sha(FLAGSHIP_RECORD))}


def test_flagship_summary_key_tree(flagship):
    s = flagship["summary"]
    with open(FLAGSHIP_RECORD) as f:
        want = q.key_tree(json.load(f))
    want["hmc_reference_literal"] = want["hmc_reference_protocol"]
    want["se"] = {
        "eval_stats": {k: None for k in q.SE_KEYS},
        **{p: {"hmc_stats": {k: None for k in q.SE_KEYS},
               "improvement": None}
           for p in ("hmc_reference_protocol", "hmc_tuned_baseline",
                     "hmc_reference_literal")}}
    want["device"] = want["commit"] = None
    assert q.key_tree(s) == want
    assert all(math.isfinite(v) for v in _numbers(s))
    assert s["device"] == "cpu" and s["commit"]
    assert s["config"]["train_steps"] == 3
    assert s["config"]["latvolume"] == [8, 8]
    for p in ("hmc_reference_protocol", "hmc_tuned_baseline",
              "hmc_reference_literal"):
        assert 0.0 < s[p]["hmc_stats"]["acc"] <= 1.0
    with open(flagship["out"] / "summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(s))
    # the committed JAX record is read, never written
    assert flagship["sha"][0] == flagship["sha"][1]


def test_flagship_hmc_protocols(flagship):
    """eval, then reference (eps None, fixed), tuned (dynamic), literal
    (eps = 1/nleapfrog of the config, fixed)."""
    calls = flagship["calls"]
    assert [c["job_type"] for c in calls] == ["eval", "hmc", "hmc", "hmc"]
    ref, tuned, literal = calls[1:]
    assert ref.get("eps") is None and ref["dynamic_step_size"] is False
    assert tuned["dynamic_step_size"] is True
    assert literal["eps"] == 1.0 / 4
    assert literal["dynamic_step_size"] is False


def test_chain_se_and_compare():
    """SE of the per-chain means on chains of known variance, the delta-
    method improvement SE, and compare's z = diff / (sqrt(2) SE)."""
    rng = np.random.default_rng(0)
    nchains, ndraws, sigma = 400, 50, 0.3
    h = History()
    for _ in range(ndraws):
        h.update({"acc": 0.7 + sigma * rng.standard_normal(nchains),
                  "dQint": 0.1 + sigma * rng.standard_normal(nchains),
                  "loss": 1.0})
    se = q.chain_se(h)
    assert set(se) == {"acc", "dQint"}
    want = sigma / math.sqrt(ndraws * nchains)    # independent draws
    assert se["acc"] == pytest.approx(want, rel=0.1)
    ds = h.get_dataset()
    means = ds["dQint"].mean(axis=1)
    assert se["dQint"] == pytest.approx(
        np.std(means, ddof=1) / math.sqrt(nchains), rel=1e-12)
    imp = q.improvement_se(2.0, {"dQint": 0.2}, {"dQint": 0.02},
                           {"dQint": 0.1}, {"dQint": 0.01})
    assert imp == pytest.approx(2.0 * math.sqrt(2) * 0.1, rel=1e-12)

    ref = {"improvement": 1.1, "walltime": 99.0,
           "train": {"elapsed": 5.0}, "hmc": {"elapsed": 3.0},
           "eval_stats": {"acc": 0.9, "dQint": 0.08, "intQ_tau_int": 50.0},
           "hmc_reference_protocol": {
               "improvement": 1.2, "protocol": "text",
               "hmc_stats": {"acc": 0.6, "dQint": 0.07}}}
    port = {"improvement": 1.0, "walltime": 1.0, "train": {"elapsed": 1.0},
            "hmc": {"elapsed": 1.0},
            "eval_stats": {"acc": 0.92, "dQint": 0.08, "intQ_tau_int": 40.0},
            "hmc_reference_protocol": {
                "improvement": 1.3, "protocol": "other",
                "hmc_stats": {"acc": 0.61, "dQint": 0.071}},
            "se": {"improvement": 0.05,
                   "eval_stats": {"acc": 0.01, "dQint": 0.004},
                   "hmc_reference_protocol": {
                       "improvement": 0.1,
                       "hmc_stats": {"acc": 0.005, "dQint": 0.001}}}}
    c = q.compare(port, ref)
    assert set(c) == {"improvement", "eval_stats.acc", "eval_stats.dQint",
                      "eval_stats.intQ_tau_int",
                      "hmc_reference_protocol.improvement",
                      "hmc_reference_protocol.hmc_stats.acc",
                      "hmc_reference_protocol.hmc_stats.dQint"}
    row = c["eval_stats.acc"]
    assert row["ref"] == 0.9 and row["port"] == 0.92
    assert row["diff"] == pytest.approx(0.02)
    assert row["z"] == pytest.approx(0.02 / (math.sqrt(2) * 0.01))
    assert c["eval_stats.intQ_tau_int"]["z"] is None
    assert c["hmc_reference_protocol.hmc_stats.dQint"]["z"] == \
        pytest.approx(0.001 / (math.sqrt(2) * 0.001))
    assert c["improvement"]["z"] == pytest.approx(-0.1 / (math.sqrt(2)
                                                          * 0.05))


def test_companion_tiny_run(tmp_path, monkeypatch):
    """The bf16 companion at 8x8 on the CPU: the JAX summary's keys plus
    se, device and commit; every value finite; the train history's
    gradients finite."""
    monkeypatch.setattr(Experiment, "make_plots", lambda self: None)
    out = tmp_path / "bf16"
    s = q.run("u1_64x64_bf16", str(out),
              ["dynamics.nchains=8", "dynamics.latvolume=[8, 8]",
               "nchains=4", "steps.nepoch=2", "steps.test=8"], device="cpu")
    with open(os.path.join(RECORDS, "u1_64x64_bf16_quality_summary.json")) \
            as f:
        want = q.key_tree(json.load(f))
    want["se"] = {"eval_stats": {k: None for k in q.SE_KEYS},
                  "hmc_stats": {k: None for k in q.SE_KEYS},
                  "improvement": None}
    want["device"] = want["commit"] = None
    assert q.key_tree(s) == want
    assert all(math.isfinite(v) for v in _numbers(s))
    with open(out / "train_health.json") as f:
        health = json.load(f)
    train = np.load(out / "train_history.npz")
    assert health["train_steps"] == 2 and health["steps_grad_nonfinite"] == 0
    assert health["grad_norm_finite_positive"]
    assert health["grad_norm_min"] == pytest.approx(
        float(train["grad_norm"].min()), rel=1e-6)
    with open(out / "train_curve.json") as f:
        rows = json.load(f)["rows"]
    assert [r[0] for r in rows] == [1, 2]
    assert all(math.isfinite(v) for r in rows for v in r)


def test_su3_8x8_b57_summary_key_tree():
    """The port's committed 8^4 beta 5.7 summary: the JAX record's key
    tree (the flowed sector statistics included) plus se, device and
    commit; values finite; the record's 600 train steps and 2000 draws;
    its train health and curve cover every train step."""
    with open(os.path.join(RECORDS, "su3_8x8_b57_quality_summary.json")) \
            as f:
        want = q.key_tree(json.load(f))
    flowed = {k: None for k in (*q.SE_KEYS, "dQint_flow", "flowQ_sector_Q2")}
    want["se"] = {"eval_stats": flowed, "hmc_stats": flowed,
                  "improvement": None}
    want["device"] = want["commit"] = None
    with open(os.path.join(PORT_RECORDS,
                           "su3_8x8_b57_quality_summary.json")) as f:
        s = json.load(f)
    assert q.key_tree(s) == want
    assert all(math.isfinite(v) for v in _numbers(s))
    assert s["device"].startswith("NVIDIA H100") and s["commit"]
    assert s["train"]["nsteps"] == 600
    assert s["eval"]["nsteps"] == s["hmc"]["nsteps"] == 2000
    with open(os.path.join(PORT_RECORDS, "su3_8x8_b57_train_health.json")) \
            as f:
        health = json.load(f)
    with open(os.path.join(PORT_RECORDS, "su3_8x8_b57_train_curve.json")) \
            as f:
        curve = json.load(f)
    assert health["train_steps"] == len(curve["rows"]) == 600
    assert [r[0] for r in curve["rows"]] == list(range(1, 601))


def test_su3_8x8_b57_rerun_summary():
    """The rerun of the 8^4 beta 5.7 record: the first run's key tree,
    600 train steps with finite positive gradients, and a curve of one
    row a step whose sumlogdet and plaqs columns are finite, sumlogdet
    0 at the first step (the networks' zero init)."""
    prefix = os.path.join(PORT_RECORDS, "su3_8x8_b57")
    with open(prefix + "_quality_summary.json") as f:
        want = q.key_tree(json.load(f))
    with open(prefix + "_rerun_quality_summary.json") as f:
        s = json.load(f)
    assert q.key_tree(s) == want
    assert all(math.isfinite(v) for v in _numbers(s))
    assert s["device"].startswith("NVIDIA H100") and s["commit"]
    with open(prefix + "_rerun_train_health.json") as f:
        health = json.load(f)
    with open(prefix + "_rerun_train_curve.json") as f:
        curve = json.load(f)
    assert health["train_steps"] == len(curve["rows"]) == 600
    assert health["steps_grad_nonfinite"] == 0
    assert health["grad_norm_finite_positive"]
    cols = curve["columns"]
    rows = np.asarray(curve["rows"])
    assert list(rows[:, 0]) == list(range(1, 601))
    for k in ("sumlogdet", "plaqs"):
        assert np.isfinite(rows[:, cols.index(k)]).all(), k
    assert rows[0, cols.index("sumlogdet")] == 0


@pytest.mark.parametrize("name,draws", [("su3_4x4_b6", 150),
                                        ("su3_8x8_b57", 2000)])
def test_frozen_record_summary(name, draws):
    """The port's committed frozen replica of a JAX SU(3) record: the JAX
    record's key tree plus se, device and commit; values finite; the
    record's 600 train steps and its draws; every train step's gradient
    finite, above 0 and with no non-finite entry; the curve one row a
    step with sumlogdet 0 and the step sizes at their start throughout."""
    with open(os.path.join(RECORDS, f"{name}_quality_summary.json")) as f:
        ref = json.load(f)
    want = q.key_tree(ref)
    se = {k: None for k in q.SE_KEYS}
    if "dQint_flow" in ref["eval_stats"]:
        se.update({"dQint_flow": None, "flowQ_sector_Q2": None})
    want["se"] = {"eval_stats": se, "hmc_stats": se, "improvement": None}
    want["device"] = want["commit"] = None
    prefix = os.path.join(PORT_RECORDS, f"{name}_frozen_")
    with open(prefix + "quality_summary.json") as f:
        s = json.load(f)
    assert q.key_tree(s) == want
    assert all(math.isfinite(v) for v in _numbers(s))
    assert s["device"].startswith("NVIDIA H100") and s["commit"]
    assert s["train"]["nsteps"] == 600
    assert s["eval"]["nsteps"] == s["hmc"]["nsteps"] == draws
    with open(prefix + "train_health.json") as f:
        health = json.load(f)
    with open(prefix + "train_curve.json") as f:
        curve = json.load(f)
    assert health["train_steps"] == len(curve["rows"]) == 600
    assert health["steps_grad_nonfinite"] == 0
    assert health["grad_norm_finite_positive"]
    cols = curve["columns"]
    rows = np.asarray(curve["rows"])
    assert list(rows[:, 0]) == list(range(1, 601))
    assert (rows[:, cols.index("sumlogdet")] == 0).all()
    for k in ("xeps", "veps"):
        assert (rows[:, cols.index(k)] == rows[0, cols.index(k)]).all(), k


def test_train_curve_one_row_per_step_across_a_restore(tmp_path,
                                                       monkeypatch):
    """train_curve.json of a tiny 8^4-record run split in two: era 0 with
    save=true, then restore=true for era 1. One row per train step, counted
    on from the first run's rows, every value finite, the logged steps
    equal to the train history's."""
    monkeypatch.setattr(Experiment, "make_plots", lambda self: None)
    out = tmp_path / "b57"
    tiny = ["dynamics.latvolume=[2, 2, 2, 2]", "network.units=[4]",
            "steps.warmup=2", "steps.nepoch=3", "steps.test=4",
            "flow_nsteps=2", "save=true"]
    q.run("su3_8x8_b57", str(out), tiny + ["steps.nera=1"], device="cpu")
    with open(out / "train_curve.json") as f:
        first = json.load(f)
    s = q.run("su3_8x8_b57", str(out), tiny + ["steps.nera=2",
                                                "restore=true"],
              device="cpu")
    with open(out / "train_curve.json") as f:
        curve = json.load(f)
    with open(out / "train_health.json") as f:
        health = json.load(f)
    cols = curve["columns"]
    assert cols == ["step", "beta", *q.CURVE_KEYS]
    assert {"sumlogdet", "plaqs"} <= set(cols)
    assert len(first["rows"]) == 3 and curve["rows"][:3] == first["rows"]
    assert [r[0] for r in curve["rows"]] == [1, 2, 3, 4, 5, 6]
    assert health["train_steps"] == 6 and s["train"]["nsteps"] == 6
    assert all(math.isfinite(v) for r in curve["rows"] for v in r)
    train = np.load(out / "train_history.npz")
    last = q.last_row(curve)
    assert last["step"] == 6
    assert last["loss"] == pytest.approx(float(train["loss"][-1]), rel=1e-6)
    assert last["acc"] == pytest.approx(float(train["acc"][..., -1].mean()),
                                        rel=1e-6)
    for k in ("sumlogdet", "plaqs"):
        assert last[k] == pytest.approx(float(train[k][..., -1].mean()),
                                        rel=1e-6, abs=1e-6), k
    for job in ("eval_stats", "hmc_stats"):
        assert {"flowQ_sector_Q2", "flowQ_max_abs_sector",
                "dQint_flow"} <= set(s[job])
        assert {"dQint_flow", "flowQ_sector_Q2"} <= set(s["se"][job])


def test_flowloss_tiny_writes_only_outdir(tmp_path, monkeypatch):
    """2^4, 2 flow steps, 1 train step: partial and final JSON land under
    outdir; nothing appears in the working directory or under records/."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    records_before = sorted(os.listdir(RECORDS))
    out = tmp_path / "flow"
    s = fw.main(str(out), 1, 1, 2, 2, baseline=os.path.join(
        RECORDS, "su3_8x8_b57_quality_summary.json"), extra=TINY_SU3,
        device="cpu")
    assert os.listdir(cwd) == []
    assert sorted(os.listdir(RECORDS)) == records_before
    assert {"summary.json", "train_partial.json"} <= set(os.listdir(out))
    with open(out / "train_partial.json") as f:
        partial = json.load(f)
    assert len(partial["loss"]) == 1 and partial["grad_nonfinite"] == [0.0]
    assert math.isfinite(s["improvement_vs_committed_hmc"])
    assert s["protocol"] == {"nera": 1, "nepoch": 1, "warmup": 2,
                             "eval_steps": 2}
    assert s["hmc_stats_committed_baseline"]["dQint"] > 0
    assert s["device"] == "cpu"


def test_hmc_spread_tiny(tmp_path):
    """The flagship's two HMC baselines repeated over seeds from one
    thermalised start: per run the means and both standard errors, over
    runs their spread; the tuned runs adapt eps, the reference ones not."""
    from l2hmc_torch.records import hmc_spread as hs
    out = hs.main(str(tmp_path), seeds=2, therm=5, block=4,
                  extra=["dynamics.nchains=16", "dynamics.latvolume=[8, 8]",
                         "nchains=8", "steps.test=12"], device="cpu")
    assert set(out["spread"]) == set(hs.PROTOCOLS)
    for name, runs in out["runs"].items():
        assert [r["seed"] for r in runs] == [1000, 1001]
        stats = out["spread"][name]
        for k in hs.KEYS:
            vals = [r[k] for r in runs]
            assert stats[k]["mean"] == pytest.approx(np.mean(vals))
            assert stats[k]["std_over_runs"] == pytest.approx(
                np.std(vals, ddof=1))
            assert all(math.isfinite(v) for v in stats[k].values())
    with open(tmp_path / "hmc_spread.json") as f:
        assert json.load(f)["config"]["seeds"] == 2
    # batch means of a known series: blocks of 4 over 12 draws
    h = History()
    for t in range(12):
        h.update({"acc": np.full(3, float(t // 4)), "dQint": np.zeros(3)})
    se = hs.draws_se(h, 4)
    assert se["acc"] == pytest.approx(1.0 / math.sqrt(3))
    assert se["dQint"] == 0.0
