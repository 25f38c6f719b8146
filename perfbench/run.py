"""Run one cell of the benchmark once on the CUDA card(s) of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Builds the cell's configuration through
l2hmc_torch, makes the weights, the starting links and every step's
draws on the card from --seed, warms up the cell's own steps (set-up),
measures the cell's loop for about --seconds, compares what the window
produced with the plain reference, and prints one JSON line as the last
line of standard output: with --trace 0 the cell's end-to-end metrics,
with --trace 1 its per-layer metrics from a profiled stretch inside the
window. The numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.

There is no fallback: without a CUDA card (or with fewer than the cell
asks for), or with JAX or the JAX package loaded in this process, it
exits non-zero and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds
    its CUDA kernel into build/ beside them)."""
    base = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    _caches()
    from perfbench import bench
    cell = bench.load_cell(args.workload)
    import torch
    torch.set_num_threads(4)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card here; nothing measured",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    res = bench.execute(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T0)
    bad = sorted(set(res.pop("_forbidden")) | set(bench.forbidden_modules()))
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    times = res.pop("_times")
    print("perfbench: " + json.dumps(times), file=sys.stderr)
    print("perfbench: not judged " + json.dumps(res.pop("_unjudged")),
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    checks = res.pop("checks")
    res["checks"] = checks
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
