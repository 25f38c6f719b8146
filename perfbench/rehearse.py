"""Rehearse a cell on the CPU at its configuration's tiny rehearsal size.

    python3 perfbench/rehearse.py --workload <name> [--seed N]

Drives the same path as run.py (the program's own loop, the wrappers,
the records and the comparison with the reference) on the CPU, with the
overrides under "rehearsal" in the configuration file. It prints the
numbers compared and `correct`, and never a time, a rate or any device
metric: on the CPU there is nothing of the card to measure.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rehearse(workload: str, seed: int = 1) -> dict:
    """Run the cell at its rehearsal size on the CPU; returns
    {"correct", "checks", "steps"}."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import bench
    cell = bench.load_cell(workload, rehearsal=True)
    # no window length: the shortest window that a traced stretch needs
    cell.traffic = dict(cell.traffic, trace_seconds=0.0)
    res = bench.execute(cell, seed, 0.0, False, "cpu", time.perf_counter())
    return {"correct": res["correct"], "checks": res["checks"],
            "steps": res["_times"]["steps"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    print(json.dumps(rehearse(args.workload, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
