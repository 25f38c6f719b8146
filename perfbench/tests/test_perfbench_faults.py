"""A run with the timed path broken underneath comes out not correct: the
rest of a run (the program's own loop, the records, the comparison) is
driven on the CPU at the rehearsal size, past the look for a card, once
for each fault the cell can have: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. (One card: no exchange between cards to leave out.)"""
import time

import pytest
import torch

from perfbench import bench
from perfbench.tests.conftest import WORKLOADS


def _alter(x):
    x = x.clone()
    x[0] = x[1]
    return x


def _break(monkeypatch, job, fault):
    from l2hmc_torch.models.loss import LatticeLoss
    from l2hmc_torch.train.trainer import Trainer
    name = {"train": "_train_body", "eval": "_eval_body",
            "hmc": "_hmc_body"}[job]
    body = getattr(Trainer, name)
    if job == "train" and fault == "half":
        calc = LatticeLoss.calc_loss

        def half(self, x0, xp, acc):
            n = x0.shape[0] // 2
            return calc(self, x0[:n], xp[:n], acc[:n])
        monkeypatch.setattr(LatticeLoss, "calc_loss", half)
        return
    if job == "train" and fault == "unchanged":
        monkeypatch.setattr(Trainer, "_apply_update",
                            lambda self, *a, **k: None)

    def broken(self, x, *a, **k):
        xout, out = body(self, x, *a, **k)
        if fault == "unchanged":
            return x.clone(), out
        if fault == "half":
            n = x.shape[0] // 2
            return torch.cat([xout[:n], x[n:]]), out
        return _alter(xout), out
    monkeypatch.setattr(Trainer, name, broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_step_is_not_correct(monkeypatch, workload, fault):
    cell = bench.load_cell(workload, rehearsal=True)
    _break(monkeypatch, cell.traffic["job"], fault)
    res = bench.execute(cell, 7, 0.0, False, "cpu", time.perf_counter())
    assert not res["correct"], res["checks"]
