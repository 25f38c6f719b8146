"""How far each package's own HMC warmup leaves the SU(3) links off the
group, and what that does to the first train step after it, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_su3_drift.py [LATVOLUME] [NWARM] \
        [NSEEDS] [--dh NTRAJ]

At the SU(3) 8^4 beta 5.7 record's knobs (`quality.SU3_8X8_B57`, float32,
cold start) on a LATVOLUME lattice (default [2,2,2,2]) at the first era's
beta 5.2, each package runs its Trainer's warmup (NWARM trajectories,
default 200, the step size self-tuned) from its own random stream, then
one train step (with lr 0, so every seed starts from the zero-init
networks). One line per package and seed: the mean of |x^dag x - 1|
(`checkSU`), S(x) - S(reunit x) per chain (both with the port's
functions), and each chain's acceptance in the train step, which
re-unitarizes the links it updates. The JAX step is compiled once (~3
min at 2^4).

`--dh NTRAJ` then takes the JAX chain on from its warmup at the records'
last beta (5.7) and, for each of NTRAJ float32 HMC trajectories (eps
0.02, 8 leapfrog steps, the eval's HMC) from the same links and momenta,
prints dH = H0 - H1 of the JAX engine, of the port's engine and of the
port's engine with the plain Horner `expm` (`plain_horner_expm`, the form
before its recurrence ran on exp(m) - 1): the means of dH and of
min(1, exp(dH)) show how much each form's float32 rounding moves the
acceptance.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from l2hmc_torch.configs import get_config as tget_config  # noqa: E402
from l2hmc_torch.ops import su3 as su3g  # noqa: E402
from l2hmc_torch.ops import su3_comp as comp  # noqa: E402
from l2hmc_torch.records.quality import SU3_8X8_B57  # noqa: E402
from l2hmc_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from l2hmc_tpu.configs import get_config  # noqa: E402
from l2hmc_tpu.train.trainer import Trainer  # noqa: E402


def plain_horner_expm(m, order: int = 12, s: int = 2):
    """`su3_comp.expm` with 1 + y rounded at every Horner step."""
    m = comp.scale(m, 1.0 / (2 ** s))
    eye = comp._eye3(m.re)
    x = comp.F3(eye + m.re / order, m.im / order)
    for i in range(order - 1, 0, -1):
        p = comp.mm(m, x)
        x = comp.F3(eye + p.re / i, p.im / i)
    for _ in range(s):
        x = comp.mm(x, x)
    return x


def dh_table(jtr, x, key, ntraj: int, lat) -> None:
    """dH of the same float32 HMC trajectories in the JAX engine, the
    port's engine and the port's engine with `plain_horner_expm`."""
    from l2hmc_tpu.ops import su3_comp as jcomp
    nb, eps, nlf, beta = x.shape[0], 0.02, 8, 5.7
    traj = jax.jit(lambda a, b: jcomp.hmc_trajectory(a, b, beta, eps, nlf,
                                                     lat, nb))
    out = {"jax": [], "port": [], "port_plain_horner": []}
    expm = comp.expm
    for t in range(ntraj):
        key, kv, ku = jax.random.split(key, 3)
        v = jtr.dynamics.random_v(kv, x)
        xp, _, dh = traj(jcomp.from_complex_lattice(x),
                         jcomp.from_complex_lattice(v))
        out["jax"].append(np.asarray(dh, np.float64))
        tx = comp.from_complex_lattice(torch.as_tensor(np.array(x)))
        tv = comp.from_complex_lattice(torch.as_tensor(np.array(v)))
        for name, form in (("port", expm),
                           ("port_plain_horner", plain_horner_expm)):
            comp.expm = form
            try:
                _, _, tdh = comp.hmc_trajectory(tx, tv, beta, eps, nlf, lat,
                                                nb)
            finally:
                comp.expm = expm
            out[name].append(tdh.double().numpy())
        # the JAX chain goes on by its own Metropolis decision
        u = np.asarray(jax.random.uniform(ku, (nb,)))
        keep = u < np.minimum(1.0, np.exp(np.asarray(dh, np.float64)))
        xn = np.asarray(jcomp.to_complex_lattice(xp, lat, nb, x.dtype))
        x = jax.numpy.asarray(np.where(keep.reshape(-1, *[1] * (x.ndim - 1)),
                                       xn, np.asarray(x)))
    for name, dhs in out.items():
        d = np.stack(dhs)
        print(f"dH {name}: trajectories {d.shape[0]} x {nb} chains, mean "
              f"dH {d.mean():+.5f}, mean min(1, exp dH) "
              f"{np.minimum(1.0, np.exp(d)).mean():.5f}", flush=True)
    jd = np.stack(out["jax"])
    for name in ("port", "port_plain_horner"):
        diff = np.stack(out[name]) - jd
        print(f"dH {name} - jax: mean {diff.mean():+.3e}, mean |.| "
              f"{np.abs(diff).mean():.3e}", flush=True)


def main(argv) -> int:
    ntraj = 0
    if "--dh" in argv:
        i = argv.index("--dh")
        ntraj = int(argv[i + 1])
        del argv[i:i + 2]
    lat = argv[0] if argv else "[2,2,2,2]"
    nwarm = int(argv[1]) if len(argv) > 1 else 200
    nseeds = int(argv[2]) if len(argv) > 2 else 2
    # lr 0: every seed starts from the zero-init networks
    overrides = SU3_8X8_B57 + [f"dynamics.latvolume={lat}",
                               "learning_rate.lr_init=0"]
    jtr = Trainer(get_config(overrides, group="SU3"))
    ttr = TTrainer(tget_config(overrides, group="SU3"), device="cpu")
    shape = tuple(ttr.cfg.dynamics.latvolume)
    beta = float(ttr.cfg.annealing_schedule.beta_init)

    def report(pkg, seed, x, acc):
        x = torch.as_tensor(np.array(x))
        nb = x.shape[0]
        xr = comp.to_complex_lattice(
            comp.reunit(comp.from_complex_lattice(x)), shape, nb, x.dtype)
        ds = ttr.dynamics.lattice.action(x, beta) \
            - ttr.dynamics.lattice.action(xr, beta)
        ds = np.round(ds.double().numpy(), 4).tolist()
        acc = np.round(np.asarray(acc, np.float64), 3).tolist()
        print(f"{pkg} seed {seed}: checkSU mean "
              f"{float(su3g.checkSU(x)[0].mean()):.3e}; S(x) - S(reunit x) "
              f"{ds}; first train step acc {acc}", flush=True)

    torch.set_num_threads(2)
    for seed in range(nseeds):
        ts, x = jtr.init_state(jax.random.PRNGKey(seed))
        x, key = jtr.warmup(x, beta, jax.random.PRNGKey(100 + seed),
                            nsteps=nwarm, exact=True)
        _, _, jm = jtr.train_step(ts, x, beta, key)
        report("jax ", seed, x, jm["acc"])
        gen = torch.Generator().manual_seed(seed)
        tx = ttr.warmup(ttr.random_x(gen), beta, gen, nsteps=nwarm,
                        exact=True)
        _, tm = ttr.train_step(tx, beta, gen)
        report("port", seed, tx, tm["acc"])
    if ntraj:
        ts, x = jtr.init_state(jax.random.PRNGKey(0))
        x, key = jtr.warmup(x, 5.7, jax.random.PRNGKey(7), nsteps=nwarm,
                            exact=True)
        dh_table(jtr, x, key, ntraj, shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
