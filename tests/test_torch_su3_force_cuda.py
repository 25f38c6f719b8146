"""The CUDA SU(3) force kernel and its backward (ops/kernels/su3_force.py)
against the plain `su3_comp.force_and_traces_plain` and its autograd VJP,
on the card.

Skips on a machine without CUDA. Imports no JAX, so it also runs where the
JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_su3_force_cuda.py

Tolerances: the links are Haar random (|U_ij| <= 1) and beta is 5.7, so a
force component is at most ~11 and one plaquette's Re tr at most 3. In
float64 the kernel and the plain version differ by rounding alone: 1e-12
on the force and 1e-12 per plaquette on the trace sums (each sums 6 V
plaquette traces). In float32 both are held to the float64 plain version:
the force to 2e-5 (about 200 float32 ulps of the largest component: 13
products of 27 multiply-adds each, summed in another order), the trace
sums to 1e-6 per plaquette, more than the plain float32 version's own
error. The kernel sums the traces in double, so its float32 error there is
its per-link rounding alone.

The backward is held to the float64 plain version's autograd VJP, for
Gaussian cotangents (the force's and the traces'), relative to the
largest component of that VJP (~30-60 at beta 5.7: each link gathers 27
products of unit-sized links with cotangents of ~2): float64 to 1e-12 (the
two differ by rounding alone, ~1e-14 of the largest component summed over
some 30 products in another order); float32 to 1e-5 (the links and
cotangents rounded to float32, 6e-8 each, and ~1,000 float32 operations a
link, against the float64 yardstick; about 100 float32 ulps of the largest
component). gradcheck holds it to finite differences of the forward
kernel in float64 at its default tolerances.
"""
import math

import pytest
import torch

from l2hmc_torch.ops import su3 as su3g
from l2hmc_torch.ops import su3_comp as comp
from l2hmc_torch.ops import wilson_flow as wf
from l2hmc_torch.ops.kernels import launches
from l2hmc_torch.ops.kernels import su3_force as sk

torch.set_num_threads(1)

# (lattice, chains): one chain; the benchmark's 8 chains at 4^4 and 8^4;
# uneven extents and an odd chain count (blocks start mid-chain); extents
# of 2, where the +1 and -1 neighbours coincide; more chains than a block
# has threads (each block's partials then hold one value a chain, and the
# last block sums each chain's column alone)
SHAPES = [((4, 4, 4, 4), 1), ((4, 4, 4, 4), 8), ((8, 8, 8, 8), 8),
          ((4, 6, 2, 8), 3), ((2, 2, 2, 2), 2), ((2, 2, 2, 2), 300)]
BETA = 5.7
TOLS = {torch.float64: (1e-12, 1e-12), torch.float32: (2e-5, 1e-6)}
#: the backward's error over the largest component of the plain VJP
BWD_TOLS = {torch.float64: 1e-12, torch.float32: 1e-5}
#: which cotangents the backward is given
COTANGENTS = ["force", "trace", "both"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _links(lat, nb, device, seed=0) -> comp.F3:
    """Haar random links, float64, in the engine's layout, reunitarised:
    the plain version's down staples rest on U^ U = 1 (a Haar draw holds
    it to ~1e-12, which moves the float64 force by ~1e-11)."""
    g = torch.Generator(device).manual_seed(seed)
    u = su3g.random((nb, 4, *lat, 3, 3), g, torch.complex128, device)
    return comp.reunit(comp.from_complex_lattice(u))


def _as(x: comp.F3, dtype) -> comp.F3:
    return comp.F3(x.re.to(dtype).contiguous(), x.im.to(dtype).contiguous())


def _kernel(x: comp.F3, beta, lat, nb):
    f_re, f_im, tr = sk.force_and_traces(x.re, x.im, beta, lat, nb)
    return comp.F3(f_re, f_im), tr


def _assert_close(f, tr, want_f, want_tr, dtype, lat):
    f_tol, tr_tol = TOLS[dtype]
    for a, b in zip(f, want_f):
        torch.testing.assert_close(a.double(), b.double(), atol=f_tol,
                                   rtol=0)
    torch.testing.assert_close(tr.double(), want_tr.double(),
                               atol=tr_tol * 6 * math.prod(lat), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lat,nb", SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, lat, nb, dtype):
    x64 = _links(lat, nb, cuda_device)
    want_f, want_tr = comp.force_and_traces_plain(x64, BETA, lat, nb)
    f, tr = _kernel(_as(x64, dtype), BETA, lat, nb)
    assert f.re.dtype == dtype and tr.shape == (nb,)
    _assert_close(f, tr, want_f, want_tr, dtype, lat)
    # through the engine's dispatch, which takes it under no_grad
    with torch.no_grad():
        f2, tr2 = comp.force_and_traces(_as(x64, dtype), BETA, lat, nb)
    assert torch.equal(f2.re, f.re) and torch.equal(f2.im, f.im)
    assert torch.equal(tr2, tr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_plain_off_the_group(cuda_device, dtype):
    """Links off SU(3) (Haar links plus 0.05 Gaussian noise a component,
    |U^ U - 1| ~ 0.5; a float32 hot start of `su3.random` is off by up
    to ~0.08): the plain version's shared-plaquette identity differs from
    the bare staple sum there, and the kernel gives the plain version's
    force, within the same tolerances."""
    lat, nb = (4, 6, 2, 8), 3
    x = _links(lat, nb, cuda_device, seed=5)
    g = torch.Generator(cuda_device).manual_seed(6)
    x64 = comp.F3(*(t + 0.05 * torch.randn(t.shape, generator=g,
                                            device=cuda_device,
                                            dtype=t.dtype) for t in x))
    want_f, want_tr = comp.force_and_traces_plain(x64, BETA, lat, nb)
    bare = comp.projectTAH(comp.mm(x64, comp.staples(x64, lat, nb)))
    assert float((bare.re * (BETA / 3) - want_f.re).abs().max()) > 1e-2
    f, tr = _kernel(_as(x64, dtype), BETA, lat, nb)
    _assert_close(f, tr, want_f, want_tr, dtype, lat)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_is_deterministic_and_reads_beta_from_the_card(
        cuda_device, dtype):
    """Two launches on one input give the same bits; beta as a 0-d tensor
    on the card gives the bits of beta as a number."""
    lat, nb = (4, 6, 2, 8), 3
    x = _as(_links(lat, nb, cuda_device, seed=1), dtype)
    f, tr = _kernel(x, BETA, lat, nb)
    f2, tr2 = _kernel(x, BETA, lat, nb)
    b = torch.tensor(BETA, dtype=dtype, device=cuda_device)
    f3, tr3 = _kernel(x, b, lat, nb)
    for other_f, other_tr in ((f2, tr2), (f3, tr3)):
        assert torch.equal(f.re, other_f.re) and torch.equal(f.im, other_f.im)
        assert torch.equal(tr, other_tr)


@pytest.mark.cuda
def test_cuda_graph_replays_the_beta_it_reads_and_counts_launches(
        cuda_device):
    """A graph captured at beta 1 and replayed after the device scalar is
    set to 5.7 gives the plain version at 5.7; launches count once each,
    eager or replayed, and not when recorded."""
    lat, nb = (4, 4, 4, 4), 8
    x64 = _links(lat, nb, cuda_device, seed=2)
    x = _as(x64, torch.float32)
    b = torch.tensor(1.0, device=cuda_device)
    sk.reset_launch_counts()
    _kernel(x, b, lat, nb)                  # build and load outside capture
    assert sk.launch_counts() == {"su3_force_fwd": 1, "su3_force_bwd": 0}
    graph = torch.cuda.CUDAGraph()
    with launches.captured() as rec, torch.cuda.graph(graph):
        f, tr = _kernel(x, b, lat, nb)
        f1, _ = _kernel(x, 2.0, lat, nb)
    assert rec == {"su3_force_fwd": 2}
    assert sk.launch_counts() == {"su3_force_fwd": 1, "su3_force_bwd": 0}
    b.fill_(BETA)
    for _ in range(2):
        graph.replay()
        launches.count_replay(rec)
    torch.cuda.synchronize()
    assert sk.launch_counts() == {"su3_force_fwd": 5, "su3_force_bwd": 0}
    want_f, want_tr = comp.force_and_traces_plain(x64, BETA, lat, nb)
    _assert_close(f, tr, want_f, want_tr, torch.float32, lat)
    want_f1, _ = comp.force_and_traces_plain(x64, 2.0, lat, nb)
    for a, w in zip(f1, want_f1):
        torch.testing.assert_close(a.double(), w, atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_reads_views_of_a_complex_lattice(cuda_device, dtype):
    """re and im as the halves of one complex buffer (pitch 2), as
    su3_comp.from_complex_lattice gives them where no copy is needed: the
    bits of the contiguous planes."""
    lat, nb = (4, 6, 2, 8), 3
    x = _as(_links(lat, nb, cuda_device, seed=4), dtype)
    c = torch.complex(x.re, x.im)
    assert sk.pitch(c.real, c.imag) == 2
    f, tr = _kernel(x, BETA, lat, nb)
    fv, trv = _kernel(comp.F3(c.real, c.imag), BETA, lat, nb)
    assert fv.re.is_contiguous() and fv.im.is_contiguous()
    assert torch.equal(f.re, fv.re) and torch.equal(f.im, fv.im)
    assert torch.equal(tr, trv)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    lat, nb = (2, 2, 2, 2), 2
    x = _as(_links(lat, nb, cuda_device), torch.float32)
    with pytest.raises(ValueError, match="non-trainable"):
        _kernel(x, torch.tensor(1.0, device=cuda_device,
                                requires_grad=True), lat, nb)
    with pytest.raises(ValueError, match="shaped"):
        _kernel(x, 1.0, (2, 2, 2, 4), nb)
    with pytest.raises(ValueError, match="one pitch"):
        sk.force_and_traces(x.re.transpose(0, 1), x.im, 1.0, lat, nb)
    with pytest.raises(TypeError, match="not supported"):
        sk.force_and_traces(x.re.half(), x.im.half(), 1.0, lat, nb)
    with pytest.raises(ValueError, match="CUDA"):
        sk.force_and_traces(x.re.cpu(), x.im.cpu(), 1.0, lat, nb)


@pytest.mark.cuda
def test_cuda_flowed_draw_matches_the_plain_path(cuda_device):
    """A 3-step Wilson flow of a 4^4 x 2 float32 field through the kernel
    (under no_grad, as a draw flows) against the plain path on the same
    card (an unmarked copy of the engine's roll keeps every force call on
    it): the flowed plaquettes and clover charges within the draw cell's
    `flowplaq` and `flowq` limits, 3e-6."""
    lat, nb = (4, 4, 4, 4), 2
    g = torch.Generator(cuda_device).manual_seed(3)
    n = 4 * math.prod(lat) * nb
    p = comp.random_momentum(n, g, torch.float64, cuda_device)
    x = _as(comp.reunit(comp.expm(comp.scale(p, 0.4))), torch.float32)
    own = comp.make_roll(lat, nb)

    def plain_roll(a, shift, axis):
        return own(a, shift, axis)

    out = {}
    sk.reset_launch_counts()
    with torch.no_grad():
        for name, roll in (("kernel", own), ("plain", plain_roll)):
            res = wf.flow(x, 0.1, 3, lat, nb, roll)
            obs = wf.flow_observables(res.t, res.tr, math.prod(lat))
            q = comp.topo_charge_clover(res.x, lat, nb, own)
            out[name] = (obs["plaq"].double(), q.double())
    assert sk.launch_counts() == {"su3_force_fwd": 9, "su3_force_bwd": 0}
    (pk, qk), (pp, qp) = out["kernel"], out["plain"]
    assert float((pk - pp).abs().max()) <= 3e-6
    assert float((qk - qp).abs().max()) <= 3e-6


# ---------------------------------------------------------------------------
# The backward (su3_force_bwd) and the autograd.Function
# ---------------------------------------------------------------------------
def _cotangents(x: comp.F3, case: str, nb: int, seed: int):
    """Gaussian float64 cotangents: (force (re, im) or None, traces or
    None)."""
    dev = x.re.device
    g = torch.Generator(dev).manual_seed(seed)
    gf = None if case == "trace" else tuple(
        torch.randn(x.re.shape, generator=g, device=dev,
                    dtype=torch.float64) for _ in range(2))
    gt = None if case == "force" else torch.randn(
        (nb,), generator=g, device=dev, dtype=torch.float64)
    return gf, gt


def _plain_vjp(x: comp.F3, gf, gt, beta, lat, nb):
    """torch.autograd.grad of the plain version at x (its dtype)."""
    xr = x.re.detach().clone().requires_grad_()
    xi = x.im.detach().clone().requires_grad_()
    with torch.enable_grad():
        f, tr = comp.force_and_traces_plain(comp.F3(xr, xi), beta, lat, nb)
        pairs = [(f.re, gf[0]), (f.im, gf[1])] if gf is not None else []
        if gt is not None:
            pairs.append((tr, gt))
        return torch.autograd.grad([o for o, _ in pairs], (xr, xi),
                                   [g.to(o.dtype) for o, g in pairs])


def _kernel_vjp(x: comp.F3, gf, gt, beta, lat, nb):
    """One call of the backward kernels, the cotangents in x's dtype."""
    def cast(t):
        return None if t is None else t.to(x.re.dtype)
    g_re, g_im = (None, None) if gf is None else (cast(gf[0]), cast(gf[1]))
    return sk.force_and_traces_bwd(x.re, x.im, g_re, g_im, cast(gt), beta,
                                   lat, nb)


def _assert_vjp_close(got, want, dtype):
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((a.double() - w).abs().max()) for a, w in zip(got, want))
    assert got[0].dtype == dtype and got[0].is_contiguous()
    assert err <= BWD_TOLS[dtype] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", COTANGENTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lat,nb", SHAPES)
def test_cuda_backward_matches_the_plain_vjp(cuda_device, lat, nb, dtype,
                                             case):
    """The backward kernels against the float64 plain VJP, on Haar links,
    for the force's cotangent, the traces' or both; and the gradient
    through the engine's dispatch (the links want one: the Function) has
    the bits of the kernels' call."""
    x64 = _links(lat, nb, cuda_device, seed=11)
    gf, gt = _cotangents(x64, case, nb, seed=12)
    want = _plain_vjp(x64, gf, gt, BETA, lat, nb)
    x = _as(x64, dtype)
    got = _kernel_vjp(x, gf, gt, BETA, lat, nb)
    _assert_vjp_close(got, want, dtype)
    xr = x.re.clone().requires_grad_()
    xi = x.im.clone().requires_grad_()
    f, tr = comp.force_and_traces(comp.F3(xr, xi), BETA, lat, nb)
    pairs = [(f.re, gf[0]), (f.im, gf[1])] if gf is not None else []
    if gt is not None:
        pairs.append((tr, gt))
    via = torch.autograd.grad([o for o, _ in pairs], (xr, xi),
                              [g.to(dtype) for _, g in pairs])
    assert torch.equal(via[0], got[0]) and torch.equal(via[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", COTANGENTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_backward_matches_the_plain_vjp_off_the_group(cuda_device,
                                                           dtype, case):
    """Links off SU(3) (Haar links plus 0.05 Gaussian noise a component):
    the backward is the VJP of the plain formula as written, the U_v^ U_v
    of its down terms included, within the same tolerances."""
    lat, nb = (4, 6, 2, 8), 3
    x = _links(lat, nb, cuda_device, seed=13)
    g = torch.Generator(cuda_device).manual_seed(14)
    x64 = comp.F3(*(t + 0.05 * torch.randn(t.shape, generator=g,
                                            device=cuda_device,
                                            dtype=t.dtype) for t in x))
    gf, gt = _cotangents(x64, case, nb, seed=15)
    want = _plain_vjp(x64, gf, gt, BETA, lat, nb)
    _assert_vjp_close(_kernel_vjp(_as(x64, dtype), gf, gt, BETA, lat, nb),
                      want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_backward_is_deterministic_and_reads_views_and_beta(
        cuda_device, dtype):
    """Two backward calls on one input give the same bits; so do beta as a
    0-d tensor on the card, links as views of one complex lattice (pitch
    2), and the Function's backward through those views."""
    lat, nb = (4, 6, 2, 8), 3
    x = _as(_links(lat, nb, cuda_device, seed=16), dtype)
    gf, gt = _cotangents(x, "both", nb, seed=17)
    first = _kernel_vjp(x, gf, gt, BETA, lat, nb)
    b = torch.tensor(BETA, dtype=dtype, device=cuda_device)
    c = torch.complex(x.re, x.im)
    views = comp.F3(c.real, c.imag)
    assert sk.pitch(*views) == 2
    again = [_kernel_vjp(x, gf, gt, BETA, lat, nb),
             _kernel_vjp(x, gf, gt, b, lat, nb),
             _kernel_vjp(views, gf, gt, b, lat, nb)]
    # the Function on views of a complex lattice that wants a gradient:
    # the lattice's gradient is x_bar re + i x_bar im
    cg = c.clone().requires_grad_()
    out = sk.force_and_traces_ad(cg.real, cg.imag, b, lat, nb)
    (gc,) = torch.autograd.grad(out, (cg,), (gf[0].to(dtype),
                                             gf[1].to(dtype), gt.to(dtype)))
    again.append((gc.real, gc.imag))
    for other in again:
        assert torch.equal(first[0], other[0])
        assert torch.equal(first[1], other[1])


@pytest.mark.cuda
def test_cuda_backward_passes_gradcheck(cuda_device):
    """torch.autograd.gradcheck of the Function in float64 at 2^4 x 2 (the
    backward against finite differences of the forward kernel, every
    output, with None for outputs left unused)."""
    lat, nb = (2, 2, 2, 2), 2
    x = _links(lat, nb, cuda_device, seed=18)
    re = x.re.detach().clone().requires_grad_()
    im = x.im.detach().clone().requires_grad_()
    b = torch.tensor(BETA, dtype=torch.float64, device=cuda_device)
    assert torch.autograd.gradcheck(
        lambda a, c: sk.force_and_traces_ad(a, c, b, lat, nb), (re, im))


@pytest.mark.cuda
def test_cuda_graph_replays_forward_and_backward_bit_for_bit(cuda_device):
    """The Function's forward and a torch.autograd.grad through it,
    captured in a CUDA graph after a warm call on a side stream: a replay
    gives the bits of the eager calls; the capture records one launch of
    each kernel, and the replay counts them."""
    lat, nb = (4, 4, 4, 4), 8
    x = _as(_links(lat, nb, cuda_device, seed=19), torch.float32)
    gf, gt = _cotangents(x, "both", nb, seed=20)
    g = (gf[0].float(), gf[1].float(), gt.float())
    re = x.re.clone().requires_grad_()
    im = x.im.clone().requires_grad_()
    b = torch.tensor(BETA, device=cuda_device)

    def step():
        out = sk.force_and_traces_ad(re, im, b, lat, nb)
        return (*(t.detach() for t in out),
                *torch.autograd.grad(out, (re, im), g))

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    sk.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with launches.captured() as rec, torch.cuda.graph(graph):
        static = step()
    assert rec == {"su3_force_fwd": 1, "su3_force_bwd": 1}
    graph.replay()
    launches.count_replay(rec)
    torch.cuda.synchronize()
    assert sk.launch_counts() == {"su3_force_fwd": 1, "su3_force_bwd": 1}
    for a, e in zip(static, eager):
        assert torch.equal(a, e)


@pytest.mark.cuda
def test_cuda_backward_refuses_what_it_does_not_take(cuda_device):
    lat, nb = (2, 2, 2, 2), 2
    x = _as(_links(lat, nb, cuda_device), torch.float32)
    g = torch.zeros_like(x.re)
    with pytest.raises(ValueError, match="both given or both None"):
        sk.force_and_traces_bwd(x.re, x.im, g, None, None, 1.0, lat, nb)
    with pytest.raises(ValueError, match="cotangents"):
        sk.force_and_traces_bwd(x.re, x.im, g.double(), g.double(), None,
                                1.0, lat, nb)
    with pytest.raises(ValueError, match="cotangents"):
        sk.force_and_traces_bwd(x.re, x.im, None, None,
                                torch.zeros(nb + 1, device=cuda_device),
                                1.0, lat, nb)
    with pytest.raises(ValueError, match="CUDA"):
        sk.force_and_traces_bwd(x.re.cpu(), x.im.cpu(), None, None, None,
                                1.0, lat, nb)
