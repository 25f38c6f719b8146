"""Configuration dataclasses for l2hmc_torch.

A copy of the JAX package's `configs.py`: the same dataclasses, field
names, defaults, `DEFAULTS_U1` / `DEFAULTS_SU3`, `get_config` and
`load_yaml`, so that `get_config(overrides).to_dict()` is equal in the two
packages. The port keeps its own copy so that it never imports the JAX
package. The config shape follows the upstream l2hmc-qcd project
(`src/l2hmc/configs.py`: `Steps` @ :345, `DynamicsConfig` @ :459,
`NetworkConfig` @ :448, `LossConfig` @ :524, `AnnealingSchedule` @ :804,
`ExperimentConfig` @ :642), implemented as plain dataclasses + YAML loading.
"""
from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Synonym tables (reference configs.py:54-105)
# ---------------------------------------------------------------------------
#: accepted spellings for floating point precisions
PRECISIONS = {
    "f16": "float16", "half": "float16", "float16": "float16", "fp16": "float16",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f32": "float32", "float32": "float32", "fp32": "float32",
    "single": "float32",
    "f64": "float64", "float64": "float64", "fp64": "float64",
    "double": "float64",
}


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclass
class BaseConfig:
    def to_dict(self) -> dict:
        return asdict(self)


# ---------------------------------------------------------------------------
# Steps (reference configs.py:345-391)
# ---------------------------------------------------------------------------
@dataclass
class Steps(BaseConfig):
    nera: int
    nepoch: int
    test: int
    log: Optional[int] = None
    print: Optional[int] = None
    extend_last_era: Optional[int] = None
    #: pre-training HMC thermalization budget. 0 (default) = adaptive:
    #: run to plaquette stationarity under small caps (trainer.warmup).
    #: N > 0 = run EXACTLY N trajectories before era 0 (N//4 before each
    #: later era), no early stop — fixed-budget thermalization, the
    #: standard lattice practice for volumes where short trajectories
    #: plateau-fool the stationarity test (observed: 8^4 started training
    #: at plaq 0.0007 vs equilibrium ~0.55 because the adaptive warmup
    #: bailed after <60 steps).
    warmup: int = 0

    def __post_init__(self):
        if self.extend_last_era is None:
            self.extend_last_era = 1
        self.total = self.nera * self.nepoch
        freq = max(1, int(self.nepoch // 20))
        self.log = freq if self.log is None else self.log
        self.print = freq if self.print is None else self.print


# ---------------------------------------------------------------------------
# Network / conv / net-weights (reference configs.py:393-457; network/factory.py)
# ---------------------------------------------------------------------------
@dataclass
class ConvolutionConfig(BaseConfig):
    filters: Optional[Sequence[int]] = None
    sizes: Optional[Sequence[int]] = None
    pool: Optional[Sequence[int]] = None

    def __post_init__(self):
        if self.filters is None or len(self.filters) == 0:
            return
        if self.sizes is None:
            self.sizes = [2] * len(self.filters)
        if self.pool is None:
            self.pool = [2] * len(self.filters)
        assert len(self.filters) == len(self.sizes) == len(self.pool)


@dataclass
class NetworkConfig(BaseConfig):
    units: Sequence[int] = (16, 16, 16, 16)
    activation_fn: str = "leaky_relu"
    # NOTE (2-D lattice-sharded meshes): dropout_prob > 0 and
    # use_batch_norm are supported on single-device and 1-D data meshes
    # only; ShardedTrainerSU3 asserts both OFF at init. BN's batch
    # statistics would need a pmean over 'data' at every layer call and
    # dropout per-shard feature-aligned masks — both deliberately
    # unimplemented: they change the arithmetic the sharded==single
    # parity tests pin down, and the SU(3) configs the 2-D mesh exists
    # for (4^4+) train better without them (records/
    # su3_4x4_b6_quality.md). Set network.dropout_prob=0 and
    # network.use_batch_norm=false for mesh_shape=[d, l>1] runs.
    dropout_prob: float = 0.2
    use_batch_norm: bool = True
    # torch nn.BatchNorm1d semantics (reference network.py:507): keep
    # EMA running statistics during training and normalize with them at
    # eval. False = batch stats at eval too (round-1/2 behavior).
    bn_track_running_stats: bool = True
    # zero-init the (s, t, q) head layers so the initial sampler is
    # EXACTLY plain HMC (acceptance starts at the HMC level instead of
    # collapsing under random O(1) perturbations — essential for SU(3)
    # at 4^4+, where random heads start at acc ~0). The reference ships
    # the same capability as Dynamics.init_weights(method=...)
    # (reference dynamics.py:373-395) but defaults to torch init, as
    # does this flag.
    zero_init_heads: bool = False


@dataclass
class NetWeight(BaseConfig):
    """Per-head scaling of the (s, t, q) network outputs."""
    s: float = 1.0
    t: float = 1.0
    q: float = 1.0


@dataclass
class NetWeights(BaseConfig):
    x: NetWeight = field(default_factory=NetWeight)
    v: NetWeight = field(default_factory=NetWeight)

    def __post_init__(self):
        if isinstance(self.x, dict):
            self.x = NetWeight(**self.x)
        if isinstance(self.v, dict):
            self.v = NetWeight(**self.v)


# ---------------------------------------------------------------------------
# Dynamics (reference configs.py:459-523)
# ---------------------------------------------------------------------------
@dataclass
class DynamicsConfig(BaseConfig):
    nchains: int
    group: str
    latvolume: Sequence[int]
    nleapfrog: int
    eps: float = 0.01
    eps_hmc: Optional[float] = None
    use_ncp: bool = True
    verbose: bool = False
    eps_fixed: bool = False
    use_split_xnets: bool = True
    use_separate_networks: bool = True
    merge_directions: bool = True
    # kept for to_dict parity with the JAX package, where it selects the
    # Pallas force kernel. It has NO effect in the port: a CUDA tensor
    # always takes the hand-written CUDA force kernel
    # (ops/kernels/u1_force.py) and a CPU tensor its plain version.
    use_pallas: bool = False
    #: start from the ordered configuration (identity links / zero
    #: phases) instead of a Haar-random one. Standard lattice practice
    #: in the ordered phase: a hot start at large volume can freeze
    #: chains permanently (see models/dynamics.random_x).
    cold_start: bool = False

    def __post_init__(self):
        self.group = self.group.upper()
        assert self.group in ("U1", "SU3")
        if self.eps_hmc is None:
            # reference: trajectory length 1 (configs.py:485-487)
            nlf = self.nleapfrog * (2 if self.merge_directions else 1)
            self.eps_hmc = 1.0 / nlf
        if self.group == "U1":
            self.dim = 2
            assert len(self.latvolume) == 2
            self.nt, self.nx = self.latvolume
            self.xshape = (self.nchains, self.dim, *self.latvolume)
            self.vshape = self.xshape
        else:
            self.dim = 4
            assert len(self.latvolume) == 4
            self.link_shape = (3, 3)
            self.nt, self.nx, self.ny, self.nz = self.latvolume
            self.xshape = (
                self.nchains, self.dim, *self.latvolume, *self.link_shape
            )
            # v is stored as 3x3 traceless anti-hermitian matrices (the
            # reference's dynamics does the same despite configs.py
            # advertising an 8-vector vshape)
            self.vshape = self.xshape
        self.xdim = _prod(self.xshape[1:])
        self.volume = _prod(self.latvolume)


# ---------------------------------------------------------------------------
# Loss (reference configs.py:524-540)
# ---------------------------------------------------------------------------
@dataclass
class LossConfig(BaseConfig):
    use_mixed_loss: bool = True
    charge_weight: float = 0.01
    rmse_weight: float = 0.0
    plaq_weight: float = 0.0
    aux_weight: float = 0.0
    #: SU(3) only: when > 0, the charge loss is computed on the Wilson-
    #: FLOWED clover charge — both the initial and proposed field are
    #: flowed charge_flow_nsteps RK3 steps of size charge_flow_eps
    #: (differentiably, remat'd) before the (Q2-Q1)^2 term. Rationale
    #: (records/su3_8x8_b57_quality.md): the reference's unflowed sinQ
    #: changes by ~2.6e-4/draw at SU(3) — UV noise, ~1000x weaker than
    #: its U(1) signal — while the flowed sector charge moves ~0.126
    #: integer units/draw underneath it. Flowing inside the loss gives
    #: the optimizer the physical observable. No reference counterpart
    #: (its SU(3) charge machinery is a TODO stub,
    #: src/l2hmc/lattice/su3/pytorch/lattice.py:232-235).
    charge_flow_nsteps: int = 0
    charge_flow_eps: float = 0.1

    def __post_init__(self):
        if self.charge_flow_nsteps > 0 and self.charge_weight <= 0:
            raise ValueError(
                "loss.charge_flow_nsteps > 0 requests the flowed charge "
                "loss, but loss.charge_weight is 0 so the charge term is "
                "disabled entirely (the SU(3) preset ships qw=0 for "
                "reference parity) — set loss.charge_weight > 0. This "
                "silently no-opped an 8^4 training run once; hence the "
                "hard error.")


# ---------------------------------------------------------------------------
# Learning rate (reference conf/learning_rate/default.yaml)
# ---------------------------------------------------------------------------
@dataclass
class LearningRateConfig(BaseConfig):
    lr_init: float = 1e-3
    clip_norm: float = 0.0
    warmup: int = 0
    min_lr: float = 1e-6
    factor: float = 0.98
    patience: int = 5
    mode: str = "auto"
    monitor: str = "loss"
    cooldown: int = 0
    min_delta: float = 1e-4
    verbose: bool = False
    #: "default" = linear warmup (warmup > 0) or plateau-decayed flat lr;
    #: "noam" = transformer rate lr_init * d^-1/2 * min(s^-1/2,
    #: s*warmup^-3/2) (reference learning_rate/pytorch/learning_rate.py:11)
    schedule: str = "default"
    #: Noam model size d; 0 = infer max(network.units)
    model_size: int = 0


# ---------------------------------------------------------------------------
# Annealing schedule (reference configs.py:804-988)
# ---------------------------------------------------------------------------
@dataclass
class AnnealingSchedule(BaseConfig):
    beta_init: float = 4.0
    beta_final: Optional[float] = 6.0
    dynamic: bool = False

    def __post_init__(self):
        if self.beta_final is None or self.beta_final < self.beta_init:
            self.beta_final = self.beta_init
        self._betas = None

    def setup(self, nera: int, nepoch: int) -> dict[str, float]:
        """Linear beta ladder over eras (reference configs.py:860-876)."""
        self._betas = np.linspace(self.beta_init, self.beta_final, nera)
        self.betas = {str(i): float(b) for i, b in enumerate(self._betas)}
        return self.betas

    def beta_for_era(self, era: int, nera: int) -> float:
        if self._betas is None:
            self.setup(nera, 0)
        return float(self._betas[min(era, len(self._betas) - 1)])


# ---------------------------------------------------------------------------
# Experiment (reference configs.py:642-803)
# ---------------------------------------------------------------------------
@dataclass
class ExperimentConfig(BaseConfig):
    steps: Steps
    dynamics: DynamicsConfig
    loss: LossConfig = field(default_factory=LossConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    conv: Optional[ConvolutionConfig] = None
    net_weights: NetWeights = field(default_factory=NetWeights)
    learning_rate: LearningRateConfig = field(default_factory=LearningRateConfig)
    annealing_schedule: AnnealingSchedule = field(default_factory=AnnealingSchedule)
    seed: int = 9992
    precision: str = "float32"
    nchains: Optional[int] = None      # eval-time nchains override
    restore: bool = False
    save: bool = True
    #: improved-action rectangle coefficient (DBW2 -1.4088, Iwasaki
    #: -0.331; reference configs.py:658 top-level c1)
    c1: float = 0.0
    #: Wilson-flow eval observables (SU(3) only): when flow_nsteps > 0,
    #: every eval/hmc draw is gradient-flowed flow_nsteps RK3 steps of
    #: size flow_eps and the flowed clover topological charge (flowQ),
    #: smoothed plaquette and t^2 E land in the metrics/history
    #: (ops/wilson_flow.py; the reference's SU(3) integer charge is a
    #: TODO stub — lattice/su3/pytorch/lattice.py:232-235)
    flow_nsteps: int = 0
    flow_eps: float = 0.1
    outdir: Optional[str] = None
    profile: bool = False
    # parallelism: number of devices along the chain ('data') mesh axis;
    # None = all visible devices
    ndevices: Optional[int] = None
    # gradient accumulation: apply the optimizer every k-th train step
    # with the mean of the accumulated gradients (the reference's
    # DeepSpeed gradient_accumulation_steps; global_batch_size =
    # world * micro_bs * gas, reference configs.py:695-699)
    grad_accum_steps: int = 1
    # 2-D (data, lattice) mesh shape, e.g. [2, 4]: chains shard over the
    # first axis AND the lattice t-axis over the second (SU(3) only —
    # parallel/sharded_train.py). None/[n, 1] = 1-D data parallelism.
    # The reference has no counterpart (it replicates the lattice per
    # rank, reference configs.py:496-518).
    mesh_shape: Optional[Sequence[int]] = None
    compile: bool = True
    framework: str = "jax"
    backend: str = "shard_map"
    use_tb: bool = False
    use_wandb: bool = False
    init_aim: bool = False
    name: Optional[str] = None

    def __post_init__(self):
        for name, cls in (
            ("steps", Steps),
            ("dynamics", DynamicsConfig),
            ("loss", LossConfig),
            ("network", NetworkConfig),
            ("net_weights", NetWeights),
            ("learning_rate", LearningRateConfig),
            ("annealing_schedule", AnnealingSchedule),
        ):
            val = getattr(self, name)
            if isinstance(val, dict):
                setattr(self, name, cls(**val))
        if isinstance(self.conv, dict):
            self.conv = ConvolutionConfig(**self.conv)
        self.precision = PRECISIONS.get(str(self.precision).lower(), "float32")

    @property
    def xshape(self):
        return self.dynamics.xshape


# ---------------------------------------------------------------------------
# Programmatic config entry points (reference configs.py:991-1035)
# ---------------------------------------------------------------------------
def _set_nested(d: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def _parse_value(s: str) -> Any:
    if isinstance(s, (int, float, bool, list)) or s is None:
        return s
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        if not inner:
            return []
        return [_parse_value(tok.strip()) for tok in inner.split(",")]
    return s


DEFAULTS_U1 = dict(
    steps=dict(nera=5, nepoch=1000, test=2000),
    dynamics=dict(
        nchains=2048, group="U1", latvolume=[16, 16], nleapfrog=8,
        eps=0.1, use_ncp=True, merge_directions=True,
        # the JAX package's default (its Pallas kernel is opt-in there);
        # ignored by the port, see DynamicsConfig.use_pallas
        use_pallas=False,
    ),
    loss=dict(use_mixed_loss=True, charge_weight=0.01),
    network=dict(units=[16, 16, 16, 16], activation_fn="leaky_relu",
                 dropout_prob=0.2, use_batch_norm=True),
    annealing_schedule=dict(beta_init=4.0, beta_final=6.0),
)

DEFAULTS_SU3 = dict(
    steps=dict(nera=1, nepoch=100, test=50),
    dynamics=dict(
        nchains=8, group="SU3", latvolume=[4, 4, 4, 4], nleapfrog=4,
        eps=0.01, merge_directions=True,
    ),
    loss=dict(use_mixed_loss=False, charge_weight=0.0,
              plaq_weight=0.1, rmse_weight=0.1),
    network=dict(units=[16, 16], activation_fn="tanh",
                 dropout_prob=0.0, use_batch_norm=False),
    annealing_schedule=dict(beta_init=6.0, beta_final=6.0),
    precision="float64",
)


def get_config(overrides: Optional[Sequence[str]] = None,
               group: str = "U1") -> ExperimentConfig:
    """Build an ExperimentConfig from defaults + `key=value` dotted overrides.

    Mirrors the role of the reference's Hydra `get_config`
    (configs.py:991-1005) without requiring Hydra.
    """
    import copy
    base = copy.deepcopy(DEFAULTS_U1 if group.upper() == "U1" else DEFAULTS_SU3)
    if overrides:
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override must be key=value, got: {ov}")
            k, v = ov.split("=", 1)
            if k == "group":
                continue
            _set_nested(base, k, _parse_value(v))
    return ExperimentConfig(**base)


def load_yaml(path: str) -> ExperimentConfig:
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f)
    return ExperimentConfig(**raw)
