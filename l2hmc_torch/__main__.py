"""CLI: python -m l2hmc_torch [key=value ...]

The PyTorch port's counterpart of the JAX package's CLI: dotted-path
overrides into the config dataclasses, e.g.

  python -m l2hmc_torch dynamics.nchains=1024 steps.nepoch=500

Special overrides:
  group=U1          the only group ported so far (group=SU3 raises)
  mode=debug        tiny debug run (reference conf/mode/debug.yaml)
  device=cpu        run on the CPU (default: the CUDA card)
  outdir=...        output directory
  --config PATH     load a YAML config instead of the defaults
"""
from __future__ import annotations

import logging
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
    logging.basicConfig(
        level=logging.INFO,
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
    if group != "U1":
        raise SystemExit(f"group={group} is not ported to l2hmc_torch yet "
                         "(only U1)")

    from l2hmc_torch.experiment import Experiment, build_experiment
    if config_path is not None:
        from l2hmc_torch.configs import load_yaml
        ex = Experiment(load_yaml(config_path), device=device)
    else:
        ex = build_experiment(overrides, group=group, device=device)
    summary = ex.run()
    print(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
