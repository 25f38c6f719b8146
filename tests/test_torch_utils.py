"""The port's plots and trackers: plots write files (matplotlib is
present where the tests run) and `Experiment.make_plots` is wired; the
trackers degrade to no-ops where a backend is missing, as the JAX
package's do (tests/test_trackers.py), and walk `named_parameters()`."""
import builtins
import os

import numpy as np
import pytest
import torch

from l2hmc_torch.utils import plots
from l2hmc_torch.utils.trackers import Trackers

torch.set_num_threads(1)


def test_plots_write_files(tmp_path):
    rng = np.random.default_rng(0)
    hist = {"loss": rng.normal(size=12), "acc": rng.uniform(size=(4, 12)),
            "energy": rng.normal(size=(4, 3, 12)),
            "tag": np.array(["a"] * 12)}
    out = plots.plot_history(hist, str(tmp_path), keys=None)
    assert sorted(os.path.basename(p) for p in out) == [
        "acc.png", "energy.png", "loss.png"]
    assert all(os.path.getsize(p) > 0 for p in out)
    assert plots.plot_history(hist, str(tmp_path / "k"), keys=["loss"]) == [
        str(tmp_path / "k" / "loss.png")]
    ridge = plots.plot_ridge(rng.normal(size=(4, 40)), "intQ", str(tmp_path))
    assert os.path.getsize(ridge) > 0
    imp = plots.measure_improvement({"dQint": np.full(5, 0.2)},
                                    {"dQint": np.full(5, 0.1)},
                                    str(tmp_path))
    assert imp == pytest.approx(2.0)
    assert (tmp_path / "model_improvement.txt").exists()
    assert np.isnan(plots.measure_improvement({}, {"dQint": np.ones(2)}))


def test_plots_without_matplotlib_write_nothing(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_mpl)
    assert plots.plot_metric(np.ones(3), "loss", str(tmp_path)) is None
    assert plots.plot_ridge(np.ones((2, 3)), "q", str(tmp_path)) is None
    assert plots.plot_history({"loss": np.ones(3)}, str(tmp_path)) == []


def test_experiment_make_plots(tmp_path):
    from l2hmc_torch.experiment import build_experiment
    ex = build_experiment(
        ["dynamics.nchains=4", "dynamics.latvolume=[4, 4]",
         "dynamics.nleapfrog=1", "network.units=[4]", "steps.nera=1",
         "steps.nepoch=2", "steps.test=2", "dynamics.verbose=true",
         f"outdir={tmp_path}"], device="cpu")
    ex.train()
    ex.evaluate("eval")
    ex.make_plots()
    assert (tmp_path / "plots" / "train" / "loss.png").exists()
    assert (tmp_path / "plots" / "eval" / "acc.png").exists()
    assert (tmp_path / "plots" / "eval" / "intQ_ridge.png").exists()
    # the verbose series reach the history as (chain, leapfrog, draw)
    h = ex.trainer.histories["train"].get_dataset()
    assert h["energy"].shape == (4, 2, 2)


def _no_backends(monkeypatch):
    real = builtins.__import__

    def blocked(name, *a, **k):
        if name.split(".")[0] in ("tensorboardX", "wandb", "aim") \
                or name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", blocked)


def test_trackers_without_backends_are_noops(tmp_path, monkeypatch):
    _no_backends(monkeypatch)
    tr = Trackers(str(tmp_path), use_tb=True, use_wandb=True, use_aim=True,
                  config={"a": 1}, run_name="r")
    assert tr.tb is None and tr.wandb is None and tr.aim is None
    tr.update_summaries({"loss": torch.tensor(1.0), "acc": torch.ones(4),
                         "mc_states": object(), "none": None}, 0, "train")
    tr.log_params(torch.nn.Linear(2, 2), 0)
    tr.log_artifact(str(tmp_path))
    tr.close()


class _Sink:
    def __init__(self):
        self.scalars, self.hists = {}, {}

    def add_scalar(self, name, val, step):
        self.scalars[name] = val

    def add_histogram(self, name, a, step):
        self.hists[name] = np.asarray(a)

    def close(self):
        pass


def test_trackers_log_params_walks_named_parameters(tmp_path):
    tr = Trackers(str(tmp_path))
    tr.tb = _Sink()
    lin = torch.nn.Linear(3, 2)
    lin(torch.ones(1, 3)).sum().backward()
    tr.log_params(lin, 5)
    assert set(tr.tb.hists) == {"model/param/weight", "model/param/bias",
                                "model/grad/weight", "model/grad/bias"}
    np.testing.assert_allclose(tr.tb.hists["model/grad/weight"], 1.0)
    assert tr.tb.scalars["model/param/weight.norm"] == pytest.approx(
        float(lin.weight.detach().norm()))
    tr.update_summaries({"loss": torch.tensor(2.0), "acc": torch.ones(4) / 2},
                        1, "eval")
    assert tr.tb.scalars["eval/loss"] == 2.0
    assert tr.tb.scalars["eval/acc"] == 0.5
    assert "eval/acc" in tr.tb.hists


def test_trainer_feeds_trackers(tmp_path, monkeypatch):
    """use_tb with no backend installed: the Experiment builds its
    Trackers and the loops call them without failing."""
    _no_backends(monkeypatch)
    from l2hmc_torch.experiment import build_experiment
    ex = build_experiment(
        ["dynamics.nchains=4", "dynamics.latvolume=[4, 4]",
         "dynamics.nleapfrog=1", "network.units=[4]", "steps.nera=1",
         "steps.nepoch=2", "steps.test=2", "use_tb=true",
         f"outdir={tmp_path}"], device="cpu")
    assert ex.trainer.trackers is not None
    calls = []
    ex.trainer.trackers.update_summaries = \
        lambda m, step, job: calls.append(job)
    ex.train()
    ex.evaluate("eval")
    assert calls.count("train") == 2 and "eval" in calls
