"""CLI: python -m l2hmc_torch [key=value ...]

The PyTorch port's counterpart of the JAX package's CLI: dotted-path
overrides into the config dataclasses, e.g.

  python -m l2hmc_torch dynamics.nchains=1024 steps.nepoch=500

Special overrides:
  group=SU3         use the 4D SU(3) defaults (default U1)
  mode=debug        tiny debug run (reference conf/mode/debug.yaml)
  device=cpu        run on the CPU (default: the CUDA card)
  outdir=...        output directory
  mesh_shape=[d, l] under torchrun: d ranks over the chains, l over the
                    SU(3) lattice's t axis (default: the chains over all)
  --config PATH     load a YAML config instead of the defaults

Several processes: torchrun --nproc_per_node N -m l2hmc_torch ...; rank 0
alone prints the summary and writes the output directory.
"""
from __future__ import annotations

import logging
import os
import sys

DEBUG_OVERRIDES = [
    "dynamics.nchains=128",
    "dynamics.latvolume=[8, 8]",
    "steps.nera=2",
    "steps.nepoch=10",
    "steps.test=10",
    "steps.log=1",
]


def main(argv=None):
    # under torchrun rank 0 alone logs progress
    rank = int(os.environ.get("RANK", "0") or 0)
    logging.basicConfig(
        level=logging.INFO if rank == 0 else logging.WARNING,
        format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s",
    )
    argv = list(argv if argv is not None else sys.argv[1:])
    group = "U1"
    device = None
    overrides = []
    config_path = None
    skip_next = False
    for i, a in enumerate(argv):
        if skip_next:
            skip_next = False
            continue
        if a.startswith("group="):
            group = a.split("=", 1)[1].upper()
        elif a == "mode=debug":
            overrides.extend(DEBUG_OVERRIDES)
        elif a.startswith("device="):
            device = a.split("=", 1)[1]
        elif a == "--config":
            config_path = argv[i + 1]
            skip_next = True
        elif a.startswith("--config="):
            config_path = a.split("=", 1)[1]
        elif a.startswith("--"):
            continue
        else:
            overrides.append(a)
    if group not in ("U1", "SU3"):
        raise SystemExit(f"group must be U1 or SU3, got {group}")

    from l2hmc_torch.experiment import Experiment, build_experiment
    if config_path is not None:
        from l2hmc_torch.configs import load_yaml
        ex = Experiment(load_yaml(config_path), device=device)
    else:
        ex = build_experiment(overrides, group=group, device=device)
    try:
        summary = ex.run()
        if ex.is_main:
            print(summary)
    finally:
        from l2hmc_torch.parallel.mesh import teardown_distributed
        teardown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
