"""The CUDA kernels of the SU(3) per-link maps (ops/kernels/su3_link.py:
`su3_comp.expm` and `su3_comp.reunit` where no gradient is wanted) against
the plain bodies, on the card.

Skips on a machine without CUDA. Imports no JAX, so it also runs where the
JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_su3_link_cuda.py

The plain body runs on the same card with the engine's device check off
(the `plain` fixture), in float64: the reference of every comparison.
Tolerances:
- float64: the kernels make the plain body's products in its order, with
  fused multiply-adds; they differ by rounding alone, 1e-13 on entries of
  order 1 (a few hundred float64 ulps: 9 to 11 products of 3-term sums).
- float32 against the float64 plain body: EXPM_F32 on exponentials of
  momenta whose entries reach ~1 (each of the 9 products rounds at ~6e-8
  relative, and the two squarings double the error twice), REUNIT_F32 on
  links: the inverse square root of x^ x and the determinant's phase,
  each rounded at ~6e-8, on entries of at most ~1 (near-unitary) and a
  few (rough). These are the float32 plain body's own size of error: its
  comparison with the float64 one is held to the same numbers.
"""
import math

import pytest
import torch

from l2hmc_torch.configs import get_config
from l2hmc_torch.ops import su3 as su3g
from l2hmc_torch.ops import su3_comp as comp
from l2hmc_torch.ops.kernels import launches
from l2hmc_torch.ops.kernels import su3_link as lk
from l2hmc_torch.train.trainer import Trainer

torch.set_num_threads(1)

#: (lattice, chains): the draw cell's 8^4 x 8 and a small odd size (the
#: last block partly filled)
SHAPES = [((8, 8, 8, 8), 8), ((3, 5, 2, 7), 3)]
EXPM_F32 = 1e-6
REUNIT_F32 = {"near_unitary": 1e-6, "rough": 1e-5}
F64 = 1e-13


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def plain(monkeypatch):
    """A context in which the engine runs its plain bodies on the card."""
    class _Plain:
        def __enter__(self):
            monkeypatch.setattr(comp, "_on_card", lambda t: False)

        def __exit__(self, *exc):
            monkeypatch.undo()
    return _Plain()


def _as(x: comp.F3, dtype) -> comp.F3:
    return comp.F3(x.re.to(dtype).contiguous(), x.im.to(dtype).contiguous())


def _maxdiff(a: comp.F3, b: comp.F3) -> float:
    return max(float((p.double() - q.double()).abs().max())
               for p, q in zip(a, b))


def _momenta(lat, nb, device, seed, off_algebra: bool) -> comp.F3:
    """TAH momenta times 0.5 (entries up to ~1.5: a flow step's or a
    transition's eps v is far smaller, so the recurrence is exercised
    beyond its range of use); off the algebra, each entry scaled by
    exp(0.1 g), as the learned v update's exp(s) scales it."""
    g = torch.Generator(device).manual_seed(seed)
    n = 4 * math.prod(lat) * nb
    p = comp.scale(comp.random_momentum(n, g, torch.float64, device), 0.5)
    if off_algebra:
        p = comp.F3(*(t * torch.exp(0.1 * torch.randn(
            t.shape, generator=g, device=device, dtype=t.dtype)) for t in p))
    return p


def _links(lat, nb, device, seed, rough: bool, plain) -> comp.F3:
    """Haar links (float64, reunitarised by the plain body) plus Gaussian
    noise of 1e-4 a component (near-unitary: a flow step or a transition
    leaves links ~1e-6 off) or 0.05 (rough: |x^ x - 1| ~ 0.5)."""
    g = torch.Generator(device).manual_seed(seed)
    u = su3g.random((nb, 4, *lat, 3, 3), g, torch.complex128, device)
    with plain:
        x = comp.reunit(comp.from_complex_lattice(u))
    sigma = 0.05 if rough else 1e-4
    return comp.F3(*(t + sigma * torch.randn(t.shape, generator=g,
                                             device=device, dtype=t.dtype)
                     for t in x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lat,nb", SHAPES)
@pytest.mark.parametrize("order,s", [(8, 2), (12, 2), (12, 0)])
@pytest.mark.parametrize("off_algebra", [False, True],
                         ids=["tah", "off_algebra"])
def test_cuda_expm_matches_the_plain_body(cuda_device, plain, lat, nb,
                                          dtype, order, s, off_algebra):
    p64 = _momenta(lat, nb, cuda_device, 1, off_algebra)
    with plain:
        want = comp.expm(p64, order=order, s=s)
        own = comp.expm(_as(p64, dtype), order=order, s=s)
    tol = F64 if dtype == torch.float64 else EXPM_F32
    lk.reset_launch_counts()
    with torch.no_grad():
        got = comp.expm(_as(p64, dtype), order=order, s=s)
    assert lk.launch_counts() == {"su3_expm_fwd": 1, "su3_reunit_fwd": 0}
    assert got.re.dtype == dtype and got.re.is_contiguous()
    assert _maxdiff(got, want) <= tol
    assert _maxdiff(own, want) <= tol       # the plain body's own error


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lat,nb", SHAPES)
@pytest.mark.parametrize("rough", [False, True],
                         ids=["near_unitary", "rough"])
def test_cuda_reunit_matches_the_plain_body(cuda_device, plain, lat, nb,
                                            dtype, rough):
    x64 = _links(lat, nb, cuda_device, 2, rough, plain)
    with plain:
        want = comp.reunit(x64)
        own = comp.reunit(_as(x64, dtype))
    tol = F64 if dtype == torch.float64 else \
        REUNIT_F32["rough" if rough else "near_unitary"]
    lk.reset_launch_counts()
    with torch.no_grad():
        got = comp.reunit(_as(x64, dtype))
    assert lk.launch_counts() == {"su3_expm_fwd": 0, "su3_reunit_fwd": 1}
    assert _maxdiff(got, want) <= tol
    assert _maxdiff(own, want) <= tol
    if not rough:                       # on SU(3) to the working precision
        u = got
        assert _maxdiff(comp.mm(u, u, adj_a=True), comp.eye_like(u)) \
            <= 10 * tol
        dre, dim = comp.det3x3(u)
        assert float((dre - 1).abs().max()) <= 10 * tol
        assert float(dim.abs().max()) <= 10 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_link_kernels_read_views_at_their_strides(cuda_device, plain,
                                                       dtype):
    """re and im as the halves of one complex buffer, and as transposed
    views: the bits of the contiguous planes, with no copy in the call."""
    lat, nb = (3, 5, 2, 7), 3
    x = _as(_links(lat, nb, cuda_device, 3, False, plain), dtype)
    c = torch.complex(x.re, x.im)
    t = comp.F3(*(a.transpose(0, 1).contiguous().transpose(0, 1)
                  for a in x))
    for fn in (lambda f: comp.expm(f, order=8, s=2), comp.reunit):
        want = fn(x)
        for view in (comp.F3(c.real, c.imag), t):
            got = fn(view)
            assert torch.equal(got.re, want.re)
            assert torch.equal(got.im, want.im)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_link_kernels_are_deterministic(cuda_device, plain, dtype):
    lat, nb = (8, 8, 8, 8), 8
    x = _as(_links(lat, nb, cuda_device, 4, True, plain), dtype)
    p = _as(_momenta(lat, nb, cuda_device, 5, True), dtype)
    for a, b in ((lk.expm(*p, 8, 2), lk.expm(*p, 8, 2)),
                 (lk.reunit(*x), lk.reunit(*x))):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_cuda_graph_replays_the_link_kernels_and_counts_launches(
        cuda_device, plain):
    """A graph of one expm and one reunit, replayed twice on new inputs
    copied into its static ones: the eager bits; launches count once each,
    eager or replayed, and not when recorded."""
    lat, nb = (4, 4, 4, 4), 8
    p = _as(_momenta(lat, nb, cuda_device, 6, False), torch.float32)
    x = _as(_links(lat, nb, cuda_device, 7, False, plain), torch.float32)
    lk.reset_launch_counts()
    with torch.no_grad():
        comp.reunit(comp.expm(p, order=8, s=2))      # build and load
        assert lk.launch_counts() == {"su3_expm_fwd": 1,
                                      "su3_reunit_fwd": 1}
        graph = torch.cuda.CUDAGraph()
        with launches.captured() as rec, torch.cuda.graph(graph):
            e = comp.expm(p, order=8, s=2)
            u = comp.reunit(comp.mm(e, x))
        assert rec == {"su3_expm_fwd": 1, "su3_reunit_fwd": 1}
        assert lk.launch_counts() == {"su3_expm_fwd": 1,
                                      "su3_reunit_fwd": 1}
        for seed in (8, 9):
            q = _as(_momenta(lat, nb, cuda_device, seed, True),
                    torch.float32)
            p.re.copy_(q.re)
            p.im.copy_(q.im)
            graph.replay()
            launches.count_replay(rec)
            want = comp.reunit(comp.mm(comp.expm(q, order=8, s=2), x))
            torch.cuda.synchronize()
            assert torch.equal(u.re, want.re) and torch.equal(u.im, want.im)
    assert lk.launch_counts() == {"su3_expm_fwd": 5, "su3_reunit_fwd": 5}


@pytest.mark.cuda
def test_cuda_link_kernels_refuse_what_they_do_not_take(cuda_device):
    x = comp.F3(torch.zeros((3, 3, 8), device=cuda_device),
                torch.zeros((3, 3, 8), device=cuda_device))
    with pytest.raises(TypeError, match="not supported"):
        lk.reunit(x.re.half(), x.im.half())
    with pytest.raises(ValueError, match="CUDA"):
        lk.reunit(x.re.cpu(), x.im.cpu())
    with pytest.raises(ValueError, match="shaped"):
        lk.reunit(x.re.reshape(9, 8), x.im.reshape(9, 8))
    with pytest.raises(ValueError, match="shaped"):
        lk.expm(x.re, x.im.double(), 8, 2)
    with pytest.raises(ValueError, match="order"):
        lk.expm(*x, 0, 2)


@pytest.mark.cuda
def test_cuda_float32_expm_and_hmc_keep_links_on_su3(cuda_device):
    """tests/test_torch_su3_comp.py's
    test_float32_expm_and_hmc_keep_links_on_su3 through the kernels (and
    the force kernel) on the card, at its thresholds: float32, 2^4 x 8
    chains, step size 0.02; expm of momenta |mean drift| < 2e-9 over 20
    draws; 30 HMC trajectories of 8 leapfrog steps from the cold start,
    every one kept, |mean drift| < 3e-7."""
    lat, nb = (2, 2, 2, 2), 8
    shape = (nb, 4, *lat, 3, 3)
    gen = torch.Generator(cuda_device).manual_seed(0)

    def drift(f):
        u = comp.to_complex_lattice(f, lat, nb, torch.complex64)
        u = u.reshape(-1, 3, 3).to(torch.complex128)
        return float(((u.conj() * u).real.sum((-1, -2)) / 3 - 1).mean())

    def momenta():
        return comp.from_complex_lattice(su3g.random_momentum(
            shape, gen, torch.complex64, cuda_device))

    lk.reset_launch_counts()
    means = [drift(comp.expm(comp.scale(momenta(), 0.02)))
             for _ in range(20)]
    assert abs(sum(means) / len(means)) < 2e-9
    x = comp.from_complex_lattice(
        torch.eye(3, dtype=torch.complex64, device=cuda_device)
        .expand(shape).contiguous())
    for _ in range(30):
        x, _, _ = comp.hmc_trajectory(x, momenta(), 5.2, 0.02, 8, lat, nb)
    assert abs(drift(x)) < 3e-7
    assert lk.launch_counts() == {"su3_expm_fwd": 20 + 30 * 8,
                                  "su3_reunit_fwd": 0}


@pytest.mark.cuda
def test_cuda_flowed_draw_matches_the_plain_path(cuda_device, plain):
    """One eval draw (an 8-step merged transition and a 3-step Wilson
    flow) of a 4^4 x 4 float32 trainer, eager, through the kernels and
    again with the engine's plain bodies on the same card, from the same
    state and draws: within the draw cell's limits (xout 1e-5, plaq
    1.5e-6, flowq and flowplaq 3e-6, logdet 1e-5). The transition makes 4
    expm and 8 reunit launches, the flow 9 and 3."""
    cfg = get_config(["dynamics.nchains=4", "dynamics.latvolume=[4, 4, 4, 4]",
                      "dynamics.nleapfrog=2", "network.units=[8]",
                      "precision=float32", "flow_nsteps=3", "seed=7"],
                     group="SU3")
    tr = Trainer(cfg, device="cuda", graphs=False)
    g = torch.Generator(cuda_device).manual_seed(11)
    x = tr.random_x(g)
    x = comp.to_complex_lattice(comp.reunit(comp.from_complex_lattice(x)),
                                cfg.dynamics.latvolume, x.shape[0], x.dtype)
    def draw():
        lk.reset_launch_counts()
        with torch.no_grad():
            xo, m = tr.eval_step(x, 5.7,
                                 torch.Generator(cuda_device).manual_seed(12))
            counts = [lk.launch_counts()]
            lk.reset_launch_counts()
            f = tr._flow_observables(xo)
            counts.append(lk.launch_counts())
        return xo, m, f, counts

    xk, mk, fk, counts = draw()
    assert counts == [{"su3_expm_fwd": 4, "su3_reunit_fwd": 8},
                      {"su3_expm_fwd": 9, "su3_reunit_fwd": 3}]
    with plain:
        xp, mp, fp, counts = draw()
    assert counts == [{"su3_expm_fwd": 0, "su3_reunit_fwd": 0}] * 2

    def diff(a, b):
        return float((torch.as_tensor(a).double()
                      - torch.as_tensor(b).double()).abs().max())
    assert torch.equal(torch.as_tensor(mk["acc_mask"]),
                       torch.as_tensor(mp["acc_mask"]))
    assert diff(torch.view_as_real(xk), torch.view_as_real(xp)) <= 1e-5
    assert diff(mk["plaqs"], mp["plaqs"]) <= 1.5e-6
    assert diff(mk["sumlogdet"], mp["sumlogdet"]) <= 1e-5
    assert diff(fk["flowQ"], fp["flowQ"]) <= 3e-6
    assert diff(fk["flow_plaq"], fp["flow_plaq"]) <= 3e-6
