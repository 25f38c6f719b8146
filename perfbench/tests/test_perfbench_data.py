"""The benchmark is data: a configuration, a traffic mix, a cell's limits
and a per-layer metric are found by name from files added beside the
existing ones, none of which is edited; and each configuration's
reference block is the configuration the program runs."""
import json
import shutil

import pytest

from perfbench import bench, flops, inputs
from perfbench.tests.conftest import ROOT, WORKLOADS


def test_added_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "perfbench"
    conf = json.loads((pb / "configs" / "u1_flagship.json").read_text())
    conf["name"] = "u1_small"
    conf["overrides"] += ["dynamics.nchains=64"]
    (pb / "configs" / "u1_small.json").write_text(json.dumps(conf))
    (pb / "traffic" / "eval_short.json").write_text(json.dumps(
        {"job": "eval", "timed_warm_steps": 3, "trace_seconds": 0.5,
         "check_steps": 2}))
    (pb / "limits" / "u1_small.eval_short.json").write_text(json.dumps(
        {"control": "bf16", "limits": {"xout": 1.0}}))
    (pb / "metrics" / "graphs_captured.py").write_text(
        "def read(ctx):\n    return len(ctx['graph_stats']) or None\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "u1_small", "source": "x",
                         "file": "perfbench/configs/u1_small.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "u1_small.eval_short",
                           "config": "u1_small", "traffic": "eval_short",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "graphs_captured", "unit": "graphs",
                           "better": "lower", "source": "program_counter",
                           "layer": "train/trainer.py compiled steps",
                           "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = bench.load_cell("u1_small.eval_short", root=tmp_path)
    assert cell.traffic["job"] == "eval"
    assert cell.config["overrides"][-1] == "dynamics.nchains=64"
    assert cell.limits == {"xout": 1.0} and cell.control == "bf16"
    assert "graphs_captured" in [m["name"] for m in cell.per_layer]
    read = bench.reader("graphs_captured", root=tmp_path)
    assert read({"graph_stats": [{}, {}]}) == 2
    assert read({"graph_stats": []}) is None
    # every file that was there is as it was
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_block_is_the_programs_config(workload):
    from l2hmc_torch.configs import get_config
    for rehearsal in (False, True):
        cell = bench.load_cell(workload, rehearsal=rehearsal)
        spec = cell.spec
        cfg = get_config(cell.config["overrides"], group=spec["group"])
        d, n, lo = cfg.dynamics, cfg.network, cfg.loss
        assert d.group == spec["group"]
        assert list(d.latvolume) == spec["latvolume"]
        assert d.nleapfrog == spec["nleapfrog"] and d.merge_directions
        assert d.eps == spec["eps"] and d.eps_hmc == spec["eps_hmc"]
        assert d.nchains == spec["chains"]["train"]
        assert cfg.nchains == spec["chains"]["draw"]
        assert d.use_ncp and d.use_split_xnets and d.use_separate_networks
        assert d.eps_fixed == spec["eps_fixed"]
        assert bool(d.cold_start) == bool(spec.get("cold_start", False))
        assert list(n.units) == spec["units"]
        assert n.activation_fn == spec["activation"]
        assert n.dropout_prob == spec["dropout"]
        assert n.use_batch_norm == spec["batch_norm"]
        assert n.bn_track_running_stats and cfg.conv is None
        assert (cfg.net_weights.x.s, cfg.net_weights.v.q) == (1.0, 1.0)
        assert (lo.use_mixed_loss, lo.charge_weight, lo.plaq_weight,
                lo.rmse_weight) == (spec["loss"]["mixed"],
                                    spec["loss"]["charge_weight"],
                                    spec["loss"]["plaq_weight"],
                                    spec["loss"]["rmse_weight"])
        assert lo.aux_weight == 0 and lo.charge_flow_nsteps == 0
        assert cfg.learning_rate.lr_init == spec["lr"]
        assert cfg.learning_rate.clip_norm == spec["clip_norm"]
        assert cfg.learning_rate.warmup == 0
        assert cfg.learning_rate.schedule == "default"
        assert cfg.annealing_schedule.beta_init == spec["beta"]
        assert cfg.annealing_schedule.beta_final == spec["beta"]
        assert cfg.grad_accum_steps == 1 and cfg.c1 == 0.0
        assert cfg.flow_nsteps == spec.get("flow_nsteps", 0)
        if cfg.flow_nsteps:
            assert cfg.flow_eps == spec["flow_eps"]
        assert cfg.precision == "float32"


@pytest.mark.parametrize("config", ["u1_flagship", "su3_8x8_b57"])
def test_layout_and_size_are_the_programs(config):
    import torch
    from l2hmc_torch.configs import get_config
    from l2hmc_torch.models.dynamics import Dynamics
    from l2hmc_torch.train.trainer import dtype_for
    conf = json.loads((ROOT / "perfbench" / "configs"
                       / f"{config}.json").read_text())
    spec = dict(conf["reference"], **conf["rehearsal"]["reference"])
    cfg = get_config(conf["overrides"] + conf["rehearsal"]["overrides"],
                     group=conf["group"])
    dyn = Dynamics(cfg.dynamics, cfg.network, cfg.net_weights, cfg.conv,
                   dtype=dtype_for(cfg))
    ps, bs = inputs.layout(spec)
    assert ps == [(k, tuple(p.shape)) for k, p in dyn.named_parameters()]
    assert bs == [(k, tuple(b.shape)) for k, b in dyn.named_buffers()]
    assert flops.param_count(spec) == sum(p.numel() for p in
                                          dyn.parameters())
    assert flops.param_count(conf["reference"]) == conf["parameters"]
    params, bufs = inputs.make_state(ps, bs, spec, conf["weights"],
                                     inputs.generator(2 ** 31 + 7, 0, "cpu"),
                                     "cpu")
    assert set(params) == {k for k, _ in ps}
    assert torch.all(bufs["masks"].sum(1) == bs[0][1][1] // 2)
