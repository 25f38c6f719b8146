"""The CUDA force kernels against their plain PyTorch versions, on the card.

Skips on a machine without CUDA. Imports no JAX, so it also runs where the
JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_u1_force_cuda.py
"""
import numpy as np
import pytest
import torch

from l2hmc_torch.ops.kernels import launches
from l2hmc_torch.ops.kernels import u1_force as tk

torch.set_num_threads(1)

# (chains, nt, nx): ragged; odd nt*nx (no 16-byte copies); 32x32 (a warp
# per chain); one chain; more chains than one pass of the persistent grid
# holds; a block per chain; many passes through a deep ring
SHAPES = [(37, 8, 12), (37, 5, 7), (300, 32, 32), (1, 16, 16),
          (5000, 16, 16), (64, 64, 64), (100000, 4, 4)]


def _x(seed, dtype, nb, nt, nx):
    rng = np.random.default_rng(seed)
    return rng.uniform(-3.0, 3.0, (nb, 2 * nt * nx)).astype(dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check on "
                    "the H100)")
    return torch.device("cuda")


def _tols(dtype):
    """force atol, action rtol, backward atol (values up to ~30 at beta 4)"""
    return (2e-5, 2e-5, 1e-4) if dtype == torch.float32 \
        else (1e-12, 1e-12, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,nt,nx", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, nb, nt, nx, dtype):
    x = torch.from_numpy(_x(8, np.float64, nb, nt, nx)).to(
        cuda_device, dtype)
    f_tol, a_tol, b_tol = _tols(dtype)
    f, a = tk.force_action(x, 4.0, nt, nx)
    fp, ap = tk.force_action_plain(x, 4.0, nt, nx)
    torch.testing.assert_close(f, fp, atol=f_tol, rtol=0)
    torch.testing.assert_close(a, ap, atol=0, rtol=a_tol)
    g = torch.randn_like(x)
    gs = torch.randn(nb, dtype=dtype, device=cuda_device)
    b = tk.force_action_bwd(x, g, gs, f, 4.0, nt, nx)
    bp = tk.force_action_bwd_plain(x, g, gs, f, 4.0, nt, nx)
    torch.testing.assert_close(b, bp, atol=b_tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,nt,nx", SHAPES)
def test_cuda_backward_without_gs_matches_plain_with_zero_gs(
        cuda_device, nb, nt, nx, dtype):
    x = torch.from_numpy(_x(9, np.float64, nb, nt, nx)).to(
        cuda_device, dtype)
    g = torch.randn_like(x)
    f, _ = tk.force_action_plain(x, 4.0, nt, nx)
    b = tk.force_action_bwd(x, g, None, None, 4.0, nt, nx)
    bp = tk.force_action_bwd_plain(x, g, torch.zeros_like(x[:, 0]), f, 4.0,
                                   nt, nx)
    torch.testing.assert_close(b, bp, atol=_tols(dtype)[2], rtol=0)


@pytest.mark.cuda
def test_cuda_input_off_16_byte_alignment(cuda_device):
    """A contiguous view one element into its buffer: the kernel serves it
    with ordinary loads and is still right."""
    nb, nt, nx = 2047, 16, 16
    x0 = torch.from_numpy(_x(10, np.float32, nb, nt, nx)).to(cuda_device)
    x = x0.new_empty((x0.numel() + 1,))[1:].view(x0.shape).copy_(x0)
    assert x.data_ptr() % 16 != 0
    f, a = tk.force_action(x, 4.0, nt, nx)
    fp, ap = tk.force_action_plain(x0, 4.0, nt, nx)
    torch.testing.assert_close(f, fp, atol=2e-5, rtol=0)
    torch.testing.assert_close(a, ap, atol=0, rtol=2e-5)


@pytest.mark.cuda
def test_cuda_autograd_skips_unused_outputs(cuda_device):
    """Only the force used: backward launches once, with gS absent; only
    the action used: gF is zeros. Both equal the plain path on the CPU."""
    nb, nt, nx = 33, 8, 8
    x0 = torch.from_numpy(_x(11, np.float64, nb, nt, nx))
    for use in ("force", "action"):
        grads = []
        for dev in (cuda_device, torch.device("cpu")):
            x = x0.clone().to(dev).requires_grad_(True)
            force, act = tk.force_action_ad(x, 2.0, nt, nx)
            out = torch.sum(torch.sin(force) * 1.7) if use == "force" \
                else torch.sum(act * 0.3)
            out.backward()
            grads.append(x.grad.cpu())
        torch.testing.assert_close(grads[0], grads[1], atol=1e-10, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,nt,nx", SHAPES)
def test_cuda_kernels_read_beta_from_device_memory(cuda_device, nb, nt, nx,
                                                   dtype):
    """beta as a 0-d tensor on the card (how the steps pass it): the same
    bits as beta as a number, both kernels."""
    x = torch.from_numpy(_x(12, np.float64, nb, nt, nx)).to(
        cuda_device, dtype)
    b = torch.tensor(4.0, dtype=dtype, device=cuda_device)
    f, a = tk.force_action(x, b, nt, nx)
    fn, an = tk.force_action(x, 4.0, nt, nx)
    assert torch.equal(f, fn) and torch.equal(a, an)
    g = torch.randn_like(x)
    gs = torch.randn(nb, dtype=dtype, device=cuda_device)
    assert torch.equal(tk.force_action_bwd(x, g, gs, f, b, nt, nx),
                       tk.force_action_bwd(x, g, gs, f, 4.0, nt, nx))


@pytest.mark.cuda
def test_cuda_graph_replays_the_beta_it_reads(cuda_device):
    """A graph captured at beta 1 and replayed after the device scalar is
    set to 2.5 gives the plain version at 2.5; its launches count once per
    replay."""
    nb, nt, nx = 257, 16, 16
    x = torch.from_numpy(_x(13, np.float32, nb, nt, nx)).to(cuda_device)
    g = torch.randn_like(x)
    b = torch.tensor(1.0, device=cuda_device)
    tk.force_action(x, b, nt, nx)            # build and load outside capture
    tk.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with launches.captured() as rec, torch.cuda.graph(graph):
        f, a = tk.force_action(x, b, nt, nx)
        xb = tk.force_action_bwd(x, g, None, None, b, nt, nx)
    assert rec == {"u1_force_fwd": 1, "u1_force_bwd": 1}
    assert tk.launch_counts() == {"u1_force_fwd": 0, "u1_force_bwd": 0}
    b.fill_(2.5)
    graph.replay()
    launches.count_replay(rec)
    fp, ap = tk.force_action_plain(x, 2.5, nt, nx)
    bp = tk.force_action_bwd_plain(x, g, None, None, 2.5, nt, nx)
    torch.testing.assert_close(f, fp, atol=2e-5, rtol=0)
    torch.testing.assert_close(a, ap, atol=0, rtol=2e-5)
    torch.testing.assert_close(xb, bp, atol=1e-4, rtol=0)
    assert tk.launch_counts() == {"u1_force_fwd": 1, "u1_force_bwd": 1}


@pytest.mark.cuda
def test_cuda_beta_wanting_a_gradient_or_on_another_device_raises(
        cuda_device):
    x = torch.zeros((2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="non-trainable"):
        tk.force_action(x, torch.tensor(1.0, device=cuda_device,
                                        requires_grad=True), 4, 4)
    if torch.cuda.device_count() > 1:
        with pytest.raises(ValueError, match="is on"):
            tk.force_action(x, torch.tensor(1.0, device="cuda:1"), 4, 4)
