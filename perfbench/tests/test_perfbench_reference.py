"""The plain reference against the port on the CPU at the rehearsal size
in float64: the same numbers a run compares, to rounding, for a U(1) and
an SU(3) train step (three of them, and a thermalization trajectory) and
draw step (eval with the flowed observables, and HMC); and the float32
port passes the committed limits."""
import time

import pytest

from perfbench import bench
from perfbench.tests.conftest import WORKLOADS


def _run(workload, seed, extra=()):
    cell = bench.load_cell(workload, rehearsal=True)
    cell.config = dict(cell.config,
                       overrides=[*cell.config["overrides"], *extra])
    return bench.execute(cell, seed, 0.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_is_the_port_in_float64(workload):
    res = _run(workload, 2 ** 31 + 11, ["precision=float64"])
    numbers = {k: c["value"] for k, c in res["checks"].items()}
    numbers.update(res["_unjudged"])
    expected = ({"loss", "grad1", "dstate3", "xout"}
                if workload.endswith("train") else {"xout", "acc", "plaq"})
    assert expected <= set(numbers)
    assert max(numbers.values()) < 1e-9, numbers


@pytest.mark.parametrize("workload", WORKLOADS)
def test_float32_port_is_correct(workload):
    res = _run(workload, 5)
    assert res["correct"], res["checks"]
    assert res["metrics"] == {} or res["device"]["platform"] == "gpu"
