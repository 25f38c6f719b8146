"""The launch-count registry of the port's CUDA kernels
(l2hmc_torch/ops/kernels/launches.py): what a capture records leaves the
counts as they were, and each replay adds it once. Runs on the CPU."""
import pytest

from l2hmc_torch.ops.kernels import launches, su3_force, u1_force


@pytest.fixture
def clean():
    before = launches.counts()
    launches.reset()
    yield
    launches.reset()
    launches.count_replay(before)


def test_every_kernel_is_registered_and_each_module_reads_its_own(clean):
    assert set(launches.counts()) >= {"u1_force_fwd", "u1_force_bwd",
                                      "su3_force_fwd"}
    launches.add("su3_force_fwd", 3)
    launches.add("u1_force_bwd")
    assert su3_force.launch_counts() == {"su3_force_fwd": 3}
    assert u1_force.launch_counts() == {"u1_force_fwd": 0,
                                        "u1_force_bwd": 1}
    u1_force.reset_launch_counts()
    assert launches.counts("su3_force_fwd", "u1_force_bwd") == {
        "su3_force_fwd": 3, "u1_force_bwd": 0}


def test_a_capture_records_and_each_replay_counts(clean):
    launches.add("u1_force_fwd", 2)
    with launches.captured() as rec:
        launches.add("su3_force_fwd", 4)
        launches.add("u1_force_fwd")
    assert rec == {"su3_force_fwd": 4, "u1_force_fwd": 1}
    assert launches.counts("su3_force_fwd", "u1_force_fwd") == {
        "su3_force_fwd": 0, "u1_force_fwd": 2}
    for _ in range(3):
        launches.count_replay(rec)
    assert launches.counts("su3_force_fwd", "u1_force_fwd") == {
        "su3_force_fwd": 12, "u1_force_fwd": 5}
    # the U(1) module's names for the registry's capture and replay
    assert u1_force.captured_launches is launches.captured
    assert u1_force.count_replay is launches.count_replay


def test_a_failed_capture_records_what_it_launched(clean):
    with pytest.raises(RuntimeError):
        with launches.captured() as rec:
            launches.add("su3_force_fwd")
            raise RuntimeError("capture failed")
    assert rec == {"su3_force_fwd": 1}
    assert launches.counts("su3_force_fwd") == {"su3_force_fwd": 0}
