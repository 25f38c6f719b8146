"""The port's configs equal the JAX package's, override for override."""
import os

import pytest
import torch

from l2hmc_torch import configs as tcfg
from l2hmc_tpu import configs as jcfg

torch.set_num_threads(1)

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "l2hmc_tpu", "conf")

OVERRIDE_SETS = [
    [],
    ["dynamics.nchains=32", "dynamics.latvolume=[4, 4]",
     "network.units=[8, 8]", "loss.use_mixed_loss=false",
     "annealing_schedule.beta_final=5.5"],
    ["steps.nera=3", "steps.nepoch=7", "steps.log=2", "precision=f64",
     "dynamics.eps_fixed=true", "dynamics.use_split_xnets=false",
     "learning_rate.clip_norm=1.0", "learning_rate.schedule=noam",
     "learning_rate.warmup=10", "grad_accum_steps=2"],
    ["dynamics.merge_directions=false", "dynamics.eps_hmc=0.05",
     "network.dropout_prob=0.0", "network.use_batch_norm=false",
     "net_weights.x.s=0.0", "loss.plaq_weight=0.1", "seed=7",
     "nchains=64", "outdir=somewhere"],
]


@pytest.mark.parametrize("overrides", OVERRIDE_SETS,
                         ids=[f"set{i}" for i in range(len(OVERRIDE_SETS))])
def test_get_config_to_dict_equal(overrides):
    assert (tcfg.get_config(overrides).to_dict()
            == jcfg.get_config(overrides).to_dict())


def test_su3_defaults_equal():
    assert (tcfg.get_config([], group="SU3").to_dict()
            == jcfg.get_config([], group="SU3").to_dict())


@pytest.mark.parametrize("name", ["u1_default", "debug"])
def test_load_yaml_equal(name):
    path = os.path.join(CONF_DIR, f"{name}.yaml")
    assert tcfg.load_yaml(path).to_dict() == jcfg.load_yaml(path).to_dict()
