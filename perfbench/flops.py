"""The yardstick: the card's peaks, and the operations and bytes the
algorithm as configured needs, worked out from the shapes alone.

The counts do not follow how the program computes a step, so that a
later fusion or a cheaper formulation moves the time and not the count:
  - networks: 2 operations per weight per chain per network call, forward;
  - lattice and group arithmetic: 216 operations per 3x3 complex product
    (27 complex multiply-adds) and fixed per-link or per-site counts for
    the elementwise work, listed below;
  - a train step costs three times its forward trajectory (the backward
    pass is taken as twice the forward; recomputation is not counted),
    plus Adam's update.
"""
from __future__ import annotations

import math

#: H100 SXM data sheet, dense, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

#: U(1) force kernel, per lattice site (sin and cos one each): W (3), sin,
#: cos, 1 - cos, the action sum, 2 subtractions and 2 products
U1_FORCE_OPS_PER_SITE = 11
#: full (nb, 2 V) tensors the forward reads or writes, and (nb,) vectors
U1_FORCE_TENSORS = (2, 1)

PRODUCT = 216            # one 3x3 complex matrix product
SU3_FORCE = 13           # products per link: 6 staples of 2, and U A
SU3_PLAQ = 18            # products per site: 6 plaquettes of 3
SU3_EXP = 10             # products per link: order-8 Taylor, 2 squarings
SU3_PROJECT = 12         # products per link: x^dag x, 3 polar iterations
SU3_CLOVER = 6 * 4 * 3 + 3   # products per site: 6 planes x 4 leaves, Q
SU3_V_UPDATE = 10 * 18   # per link: 10 operations on each of 18 reals
U1_V_UPDATE = 10         # per link
U1_X_UPDATE = 30         # per link: the NCP update and its log-Jacobian
U1_ACTION = 6            # per site
KINETIC = 2              # per real momentum component
ADAM = 15                # per parameter
TRAIN_FACTOR = 3


def u1_force_bytes(nb: int, nt: int, nx: int, size: int = 4) -> int:
    """Bytes of one forward force launch: each input read once, each
    output written once."""
    full, vec = U1_FORCE_TENSORS
    return (full * nb * 2 * nt * nx + vec * nb) * size


def u1_force_bound_s(nb: int, nt: int, nx: int) -> tuple[float, str]:
    """The least time one float32 forward launch needs, and which of the
    two bounds sets it."""
    by_bytes = u1_force_bytes(nb, nt, nx) / HBM_BYTES_PER_S
    by_ops = U1_FORCE_OPS_PER_SITE * nb * nt * nx / PEAK_OPS_PER_S["float32"]
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def net_weights(spec: dict, x_dim: int, v_dim: int, out_dim: int) -> int:
    """Weights (matrix entries) of one (s, t, q) network."""
    u = list(spec["units"])
    hidden = sum(a * b for a, b in zip(u, u[1:]))
    return (x_dim + v_dim) * u[0] + hidden + 3 * u[-1] * out_dim


def param_count(spec: dict) -> int:
    """Parameters of the dynamics: step sizes, and per leapfrog step its
    networks' weights, biases, head coefficients and batch norms."""
    u = list(spec["units"])
    nlf = spec["nleapfrog"]

    def count(x_dim, v_dim, out_dim):
        n = net_weights(spec, x_dim, v_dim, out_dim) + 2 * u[0]
        n += sum(u[1:]) + 5 * out_dim
        return n + (2 * u[-1] if spec["batch_norm"] else 0)
    if spec["group"] == "U1":
        d = 2 * math.prod(spec["latvolume"])
        per = count(d, d, d) + 2 * count(2 * d, d, d)
    else:
        links = 4 * math.prod(spec["latvolume"])
        per = count(8 * links, 8 * links, 9 * links)
    return 2 * nlf + nlf * per


def trajectory_ops(spec: dict, nb: int, job: str) -> float:
    """Operations of one transition of nb chains: a merged L2HMC
    trajectory ("train", "eval") or an HMC one ("hmc")."""
    nlf = spec["nleapfrog"]
    steps = 2 * nlf
    vol = math.prod(spec["latvolume"])
    if spec["group"] == "U1":
        links = 2 * vol
        force = U1_FORCE_OPS_PER_SITE * vol
        h = 2 * (KINETIC * links + U1_ACTION * vol)
        if job == "hmc":
            # two momentum half-kicks and the link update, 2 each a link
            return nb * ((steps + 1) * force + steps * 3 * 2 * links + h)
        w_v = net_weights(spec, links, links, links)
        w_x = net_weights(spec, 2 * links, links, links)
        nets = 2 * (2 * w_v + 2 * w_x)
        per_step = (nets + force + 2 * U1_V_UPDATE * links
                    + 2 * U1_X_UPDATE * links)
        return nb * (force + steps * per_step + h)
    links = 4 * vol
    force = SU3_FORCE * PRODUCT * links
    h = 2 * (KINETIC * 8 * links + SU3_PLAQ * PRODUCT * vol)
    link_update = (SU3_EXP + 1) * PRODUCT * links
    if job == "hmc":
        kicks = 2 * 2 * 18 * links
        return nb * ((steps + 1) * force + steps * (link_update + kicks) + h)
    w_v = net_weights(spec, 8 * links, 8 * links, 9 * links)
    per_step = (2 * 2 * w_v + force + link_update
                + SU3_PROJECT * PRODUCT * links + 2 * SU3_V_UPDATE * links)
    return nb * (force + steps * per_step + h)


def flow_ops(spec: dict, nb: int, nsteps: int) -> float:
    """A Wilson flow of nsteps RK3 steps and the clover charge after it."""
    vol = math.prod(spec["latvolume"])
    links = 4 * vol
    per_step = (3 * (SU3_FORCE + SU3_EXP + 1) + SU3_PROJECT) * links \
        + SU3_PLAQ * vol
    return nb * PRODUCT * (nsteps * per_step + SU3_CLOVER * vol)


def step_ops(spec: dict, nb: int, job: str) -> float:
    """Operations of one step of the window's job."""
    if job == "train":
        return (TRAIN_FACTOR * trajectory_ops(spec, nb, "train")
                + ADAM * param_count(spec))
    ops = trajectory_ops(spec, nb, job)
    if spec["group"] == "SU3" and spec.get("flow_nsteps", 0) > 0:
        ops += flow_ops(spec, nb, spec["flow_nsteps"])
    return ops
