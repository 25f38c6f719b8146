"""`python -m l2hmc_torch device=cpu mode=debug` end to end in a
subprocess, at a tiny size: the summary has the JAX package's keys and
finite values, and the checkpoint and eps dumps exist."""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# experiment.py:221-229 of the JAX package
SUMMARY_KEYS = {"improvement", "walltime", "train", "eval", "hmc",
                "eval_stats", "hmc_stats"}


def _finite(v):
    if isinstance(v, dict):
        return all(_finite(x) for x in v.values())
    return isinstance(v, (int, float)) and math.isfinite(v)


def test_cli_debug_run_cpu(tmp_path):
    out = tmp_path / "cli"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "l2hmc_torch", "device=cpu", "mode=debug",
         "steps.nera=1", "steps.nepoch=3", "steps.test=3",
         "dynamics.nchains=8", "dynamics.latvolume=[4, 4]",
         "dynamics.nleapfrog=2", "network.units=[8]", f"outdir={out}"],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert set(summary) == SUMMARY_KEYS
    assert _finite({k: v for k, v in summary.items()})
    assert 0.0 < summary["eval_stats"]["acc"] <= 1.0
    assert os.listdir(out / "checkpoints")
    assert (out / "xeps.txt").exists() and (out / "veps.txt").exists()
    assert (out / "model_improvement.txt").exists()


def test_cli_resume_from_checkpoint(tmp_path):
    """A second run with restore=true picks up the saved era and trains
    the next one."""
    from l2hmc_torch.experiment import build_experiment
    common = ["steps.nera=2", "steps.nepoch=2", "steps.test=2",
              "dynamics.nchains=4", "dynamics.latvolume=[4, 4]",
              "dynamics.nleapfrog=1", "network.units=[4]",
              f"outdir={tmp_path}"]
    ex = build_experiment(common, device="cpu")
    ex.train(max_eras=1)
    ex2 = build_experiment(common + ["restore=true"], device="cpu")
    ex2.setup()
    assert ex2._start_era == 1
    assert ex2.trainer.step == ex.trainer.step
    for a, b in zip(ex.trainer.dynamics.parameters(),
                    ex2.trainer.dynamics.parameters()):
        assert torch.equal(a, b)


def test_port_never_imports_jax():
    """The port imports neither jax nor the JAX package, at run time or in
    its sources."""
    code = ("import sys, l2hmc_torch.__main__, l2hmc_torch.experiment;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'l2hmc_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    for root, _, files in os.walk(os.path.join(REPO, "l2hmc_torch")):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(root, name)) as f:
                    src = f.read()
                for bad in ("import jax", "from jax", "l2hmc_tpu"):
                    assert bad not in src, (name, bad)


def test_default_device_without_cuda_raises():
    from l2hmc_torch.train.trainer import resolve_device
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device=cpu"):
        resolve_device(None)


def test_su3_not_ported():
    from l2hmc_torch.experiment import build_experiment
    with pytest.raises(NotImplementedError, match="not ported"):
        build_experiment(["group=SU3"], device="cpu")
