"""Kill-and-resume of the port (tests/test_resume.py of the JAX package):
a run interrupted mid-beta-ladder and restored from its per-era checkpoint
in a fresh Experiment continues bit-identically to an uninterrupted one;
and complex leaves (the SU(3) lattice) round-trip through a checkpoint."""
import numpy as np
import pytest
import torch

from l2hmc_torch.experiment import build_experiment
from l2hmc_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

U1 = [
    "dynamics.nchains=16", "dynamics.latvolume=[4, 4]",
    "dynamics.nleapfrog=2", "network.units=[4]",
    # dropout ON: the resumed generator must continue the masks' stream
    "network.dropout_prob=0.2",
    "steps.nera=3", "steps.nepoch=3", "steps.log=1",
    # plateau decay ON with patience 1: the controller state
    # (best/wait/lr) is checkpointed per era
    "learning_rate.factor=0.5", "learning_rate.patience=1",
    "annealing_schedule.beta_init=2.0", "annealing_schedule.beta_final=3.0",
    "seed=123", "save=true",
]
SU3 = [
    "group=SU3", "dynamics.nchains=2", "dynamics.latvolume=[2, 2, 2, 2]",
    "dynamics.nleapfrog=1", "network.units=[4]", "precision=float32",
    "steps.nera=3", "steps.nepoch=2", "steps.log=1",
    "learning_rate.factor=0.5", "learning_rate.patience=1",
    "annealing_schedule.beta_init=5.0", "annealing_schedule.beta_final=6.0",
    "seed=7", "save=true",
]
ACCUM = U1 + ["grad_accum_steps=2", "annealing_schedule.dynamic=true"]


# the accumulating run dies after ONE era of 3 steps: in the middle of an
# accumulation window of 2, whose partial sum must be in the checkpoint
@pytest.mark.parametrize("base,eras", [(U1, 2), (SU3, 2), (ACCUM, 1)],
                         ids=["u1_plateau_dropout", "su3", "u1_accum_dynamic"])
def test_kill_and_resume_matches_uninterrupted(tmp_path, base, eras):
    def build(sub, extra=()):
        return build_experiment(base + [f"outdir={tmp_path / sub}", *extra],
                                device="cpu")
    # A: uninterrupted 3-era run
    ex_a = build("a")
    ex_a.train()
    # B: run `eras` eras, "die", then a FRESH Experiment restores and finishes
    ex_b1 = build("b")
    ex_b1.train(max_eras=eras)
    del ex_b1
    ex_b2 = build("b", ["restore=true"])
    ex_b2.train()

    assert ex_b2._start_era == eras       # actually resumed, not restarted
    ta, tb = ex_a.trainer, ex_b2.trainer
    assert ta.step == tb.step == 3 * ta.cfg.steps.nepoch
    assert ta.updates == tb.updates
    assert torch.equal(ta.dynamics.xeps, tb.dynamics.xeps)
    assert torch.equal(ex_a._x, ex_b2._x)
    sa, sb = ta.dynamics.state_dict(), tb.dynamics.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:      # every leaf: nets, step sizes, BN statistics, masks
        assert torch.equal(sa[k], sb[k]), k
    for pa, pb in zip(ta.dynamics.parameters(), tb.dynamics.parameters()):
        for mk in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(ta.optimizer.state[pa][mk],
                               tb.optimizer.state[pb][mk])
    assert torch.equal(ex_a.generator.get_state(),
                       ex_b2.generator.get_state())
    # the resumed history covers the full run (loaded + appended)
    ha = ta.histories["train"].get_dataset()
    hb = tb.histories["train"].get_dataset()
    assert ha["loss"].shape == hb["loss"].shape
    np.testing.assert_array_equal(ha["loss"][-1], hb["loss"][-1])
    # controller memory continued, not reset
    assert ta.controller_state() == tb.controller_state()
    assert ta.controller_state()
    assert (ta.optimizer.param_groups[0]["lr"]
            == tb.optimizer.param_groups[0]["lr"])


def test_restore_with_no_checkpoint_starts_fresh(tmp_path):
    ex = build_experiment(U1 + [f"outdir={tmp_path}", "restore=true"],
                          device="cpu")
    ex.setup()
    assert ex._start_era == 0 and ex.trainer.step == 0


def test_checkpoint_complex_leaves_roundtrip(tmp_path):
    """Complex leaves survive save -> restore with values and dtypes."""
    tree = {
        "x": torch.from_numpy((np.arange(12).reshape(3, 4)
                               + 1j * np.ones((3, 4))).astype(np.complex64)),
        "w": torch.ones((2, 2)),
        "era": 2,
    }
    ckpt.save_checkpoint(tmp_path, 7, tree)
    assert ckpt.latest_checkpoint(tmp_path).endswith("ckpt_00000007.pt")
    got = ckpt.restore_checkpoint(tmp_path)
    assert got["x"].dtype == torch.complex64
    assert torch.equal(got["x"], tree["x"])
    assert torch.equal(got["w"], tree["w"])
    assert int(got["era"]) == 2
