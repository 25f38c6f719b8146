"""The control (the reference in the program's place, in the precision
below the configuration's) and the planted faults. On the card, at the
cell's own size and on three seeds (`python -m pytest perfbench/tests -m
cuda`), they come out not correct under the committed limits, and so does TF32
in the networks' products alone in the training cells. At the
rehearsal size on the CPU, where float32 rounding is far smaller than at
the cells' sizes that the limits were set from, the reference in float32
stays under the limits, and the control and each fault read at least
three times what it reads on a number the cell judges."""
import pytest

from perfbench import bench, check, control
from perfbench.tests.conftest import WORKLOADS


def _variants(cell, card=False):
    train = cell.traffic["job"] == "train"
    faults = ["answer"] + (["half"] if train else [])
    # on the card, TF32 in the networks' products alone also fails: the
    # step a later change to the networks' GEMMs would take
    return ["control", *faults] + (["nettf32"] if train and card else [])


def _judge(cell, seed, variant, device):
    return check.judge(control.numbers(cell, seed, variant, device),
                       cell.limits)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_and_faults_stand_out_at_rehearsal_size(workload):
    cell = bench.load_cell(workload, rehearsal=True)
    sound = control.numbers(cell, 3, "sound", "cpu")
    ok, rows = check.judge(sound, cell.limits)
    assert ok, rows
    for variant in _variants(cell):
        got = control.numbers(cell, 3, variant, "cpu")
        assert any(got[k] >= 3 * max(sound[k], 1e-300)
                   for k in cell.limits), (variant, got, sound)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_and_faults_fail_on_the_card(workload, card):
    cell = bench.load_cell(workload)
    for seed in (101, 202, 2 ** 31 + 303):
        for variant in _variants(cell, card=True):
            ok, rows = _judge(cell, seed, variant, card)
            assert not ok, (seed, variant, rows)
