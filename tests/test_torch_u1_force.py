"""The port's fused U(1) force/action and its backward against the JAX
package's Pallas kernel (interpret mode) and custom VJP.

On the CPU the port's wrappers take the plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card
(tests/test_torch_u1_force_cuda.py, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_torch.ops.kernels import u1_force as tk
from l2hmc_tpu.ops.pallas import u1_kernels

torch.set_num_threads(1)

NT, NX, NB = 8, 8, 16


def _x(seed, dtype, nb=NB, nt=NT, nx=NX):
    rng = np.random.default_rng(seed)
    return rng.uniform(-3.0, 3.0, (nb, 2 * nt * nx)).astype(dtype)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5),
                                        (np.float64, 1e-12)])
def test_force_action_matches_pallas(dtype, atol):
    """float32 to 2e-5 as tests/test_pallas_u1.py holds the Pallas kernel
    to its reference; float64 to 1e-12 (the same formula)."""
    x = _x(0, dtype)
    beta = 4.0
    tf, ta = tk.force_action(torch.from_numpy(x), beta, NT, NX)
    jf, ja = u1_kernels.force_action(jnp.asarray(x), beta, NT, NX,
                                     interpret=True)
    assert tf.dtype == torch.from_numpy(x).dtype
    assert tk.launch_counts() == {"u1_force_fwd": 0, "u1_force_bwd": 0}
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=atol, rtol=0)
    rtol = 2e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=rtol)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5),
                                        (np.float64, 1e-12)])
def test_force_action_with_tensor_beta_matches_pallas(dtype, atol):
    """beta as a 0-d tensor of x's dtype (how the port's steps pass it,
    and on the card the kernel's device operand): the plain force, the
    action and the VJP against the Pallas kernel in interpret mode and
    its custom VJP, at the tolerances of the number-beta tests."""
    x = _x(13, dtype)
    beta = 3.5
    tx = torch.from_numpy(x).requires_grad_(True)
    tbeta = torch.tensor(beta, dtype=tx.dtype)
    tf, ta = tk.force_action_ad(tx, tbeta, NT, NX)
    jf, ja = u1_kernels.force_action(jnp.asarray(x), beta, NT, NX,
                                     interpret=True)
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf),
                               atol=atol, rtol=0)
    rtol = 2e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja),
                               rtol=rtol)
    torch.sum(torch.sin(tf) * 1.7).backward()

    def jloss(y):
        force, _ = u1_kernels.force_action_ad(y, jnp.asarray(beta, x.dtype),
                                              NT, NX, True)
        return jnp.sum(jnp.sin(force) * 1.7)

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    np.testing.assert_allclose(tx.grad.numpy(), g_ref,
                               atol=1e-8 if dtype == np.float64 else 2e-4,
                               rtol=0)


def test_force_action_4d_shape():
    x = _x(1, np.float64).reshape(NB, 2, NT, NX)
    f, a = tk.force_action(torch.from_numpy(x), 2.0, NT, NX)
    f2, a2 = tk.force_action(torch.from_numpy(x.reshape(NB, -1)), 2.0, NT, NX)
    assert f.shape == (NB, 2, NT, NX) and a.shape == (NB,)
    np.testing.assert_array_equal(f.reshape(NB, -1).numpy(), f2.numpy())


def test_vjp_matches_jax_custom_vjp():
    """Gradient of sum(1.7 sin F) + sum(0.3 S) through the port's
    autograd.Function == jax.grad through force_action_ad, to 1e-8 at
    float64 (both are exact VJPs of the same function)."""
    x = _x(2, np.float64)
    beta = 2.0

    def jf(y):
        force, act = u1_kernels.force_action_ad(y, jnp.float64(beta), NT, NX,
                                                True)
        return jnp.sum(jnp.sin(force) * 1.7) + jnp.sum(act * 0.3)

    g_ref = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    force, act = tk.force_action_ad(tx, beta, NT, NX)
    (torch.sum(torch.sin(force) * 1.7) + torch.sum(act * 0.3)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), g_ref, atol=1e-8, rtol=0)


def test_bwd_plain_matches_jax_fa_bwd():
    x, gf = _x(3, np.float64), _x(4, np.float64)
    gs = np.random.default_rng(5).normal(size=NB)
    beta = 3.0
    force, act = u1_kernels.force_action(jnp.asarray(x), beta, NT, NX,
                                         interpret=True)
    jbar, _ = u1_kernels._fa_bwd(NT, NX, True,
                                 (jnp.asarray(x), jnp.float64(beta), force,
                                  act),
                                 (jnp.asarray(gf), jnp.asarray(gs)))
    tbar = tk.force_action_bwd(torch.from_numpy(x), torch.from_numpy(gf),
                               torch.from_numpy(gs),
                               torch.from_numpy(np.array(force)), beta, NT,
                               NX)
    np.testing.assert_allclose(tbar.numpy(), np.asarray(jbar), atol=1e-12,
                               rtol=0)


def test_gradcheck_plain_path():
    x = torch.from_numpy(_x(6, np.float64, nb=3, nt=4, nx=4)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda y: tk.force_action_ad(y, 1.3, 4, 4), (x,))


def test_beta_requiring_grad_raises():
    x = torch.from_numpy(_x(7, np.float64))
    with pytest.raises(ValueError, match="non-trainable"):
        tk.force_action_ad(x, torch.tensor(1.0, requires_grad=True), NT, NX)


# (chains, nt, nx, x passed to the port as (nb, 2, nt, nx)?): square, odd
# nt*nx, ragged, and the 4-D input form
UNUSED_OUTPUT_SHAPES = [(5, 4, 4, False), (5, 3, 5, False), (3, 8, 12, False),
                        (5, 4, 4, True)]


@pytest.mark.parametrize("used", ["force", "action"])
@pytest.mark.parametrize("nb,nt,nx,four_d", UNUSED_OUTPUT_SHAPES)
def test_vjp_with_one_output_unused_matches_jax(nb, nt, nx, four_d, used):
    """Only the force used (gS arrives as None: the gS F term is skipped)
    or only the action used (gF arrives as None): the gradient through the
    port's autograd.Function == jax.grad of the same scalar through
    force_action_ad, to 1e-8 at float64."""
    x = _x(8, np.float64, nb=nb, nt=nt, nx=nx)
    beta = 2.0

    def jf(y):
        force, act = u1_kernels.force_action_ad(y, jnp.float64(beta), nt, nx,
                                                True)
        return jnp.sum(jnp.sin(force) * 1.7) if used == "force" \
            else jnp.sum(act * 0.3)

    g_ref = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    tx = torch.from_numpy(x.reshape(nb, 2, nt, nx) if four_d else x)
    tx.requires_grad_(True)
    force, act = tk.force_action_ad(tx, beta, nt, nx)
    out = torch.sum(torch.sin(force) * 1.7) if used == "force" \
        else torch.sum(act * 0.3)
    out.backward()
    assert tx.grad.shape == tx.shape
    np.testing.assert_allclose(tx.grad.reshape(nb, -1).numpy(), g_ref,
                               atol=1e-8, rtol=0)


def test_backward_receives_none_for_an_unused_output(monkeypatch):
    """The autograd.Function does not materialise zero gradients: with
    the action unused, force_action_bwd is called with g_act None."""
    seen = []
    real = tk.force_action_bwd

    def spy(x, g_force, g_act, force, beta, nt, nx):
        seen.append(g_act)
        return real(x, g_force, g_act, force, beta, nt, nx)

    monkeypatch.setattr(tk, "force_action_bwd", spy)
    x = torch.from_numpy(_x(9, np.float64)).requires_grad_(True)
    force, _ = tk.force_action_ad(x, 2.0, NT, NX)
    torch.sum(torch.sin(force)).backward()
    assert seen == [None]


def test_bwd_plain_without_gs_equals_zero_gs():
    x, gf = _x(10, np.float64), _x(11, np.float64)
    tx, tg = torch.from_numpy(x), torch.from_numpy(gf)
    force, _ = tk.force_action(tx, 3.0, NT, NX)
    none = tk.force_action_bwd(tx, tg, None, None, 3.0, NT, NX)
    zero = tk.force_action_bwd(tx, tg, torch.zeros(NB, dtype=tx.dtype),
                               force, 3.0, NT, NX)
    np.testing.assert_array_equal(none.numpy(), zero.numpy())


def test_beta_cpu_scalar_tensor_is_accepted():
    x = torch.from_numpy(_x(12, np.float64))
    f1, a1 = tk.force_action_ad(x, torch.tensor(1.5), NT, NX)
    f2, a2 = tk.force_action_ad(x, 1.5, NT, NX)
    np.testing.assert_array_equal(f1.numpy(), f2.numpy())
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())


@pytest.mark.parametrize("name,inputs", [
    ("u1_force", ["u1_force.cu", "hopper_async.cuh"]),
    ("su3_force", ["su3_force.cu"]),
    ("su3_link", ["su3_link.cu"])])
def test_library_path_follows_every_build_input(tmp_path, name, inputs):
    """A library's build is keyed by its source and the local headers the
    source includes: editing a copy of either changes the library's path,
    and editing another library's source does not."""
    import importlib
    import shutil
    from l2hmc_torch.ops.kernels import library
    mod = importlib.import_module(f"l2hmc_torch.ops.kernels.{name}")
    assert [p.name for p in library.build_inputs(mod.SOURCE)] == inputs
    copy = tmp_path / "l2hmc_torch" / "csrc"
    shutil.copytree(mod.SOURCE.parent, copy)
    lib = library.Library(copy / mod.SOURCE.name, {})
    assert lib.path().name == mod.LIB.path().name
    edited = sorted(p.name for p in copy.iterdir())
    assert set(inputs) < set(edited)
    for other in edited:
        before = lib.path()
        with open(copy / other, "a") as f:
            f.write("// edited\n")
        assert (lib.path() != before) == (other in inputs), other


def test_build_inputs_follow_nested_local_headers(tmp_path):
    """Headers included by headers are build inputs too, each found
    relative to the file that includes it and listed once (an include
    cycle ends); system headers are not."""
    from l2hmc_torch.ops.kernels import library
    (tmp_path / "inc").mkdir()
    (tmp_path / "a.cu").write_text(
        '#include <cstdint>\n#include "inc/b.cuh"\n  # include "c.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text('#include "d.cuh"\n')
    (tmp_path / "inc" / "d.cuh").write_text('#include "../c.cuh"\n')
    (tmp_path / "c.cuh").write_text('#include "inc/d.cuh"\n')
    got = library.build_inputs(tmp_path / "a.cu")
    assert [p.relative_to(tmp_path).as_posix() for p in got] == [
        "a.cu", "inc/b.cuh", "c.cuh", "inc/d.cuh"]


@pytest.mark.parametrize("kind,nbytes", [("fwd", 8396800),
                                         ("bwd", 16785408),
                                         ("bwd_no_gs", 12582912)])
def test_kernel_bound_counts_each_tensor_once(kind, nbytes):
    """The bound that the timing scripts print beside each kernel: every
    input read once, every output written once, over the H100's memory
    rate (the arithmetic is far below the float32 peak)."""
    from l2hmc_torch.utils import kernel_times as kt
    b = kt.bound(kind, 2048, 16, 16, torch.float32)
    assert b["bytes"] == nbytes and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("case", ["whole", "dropped"])
def test_kernel_time_per_call_survives_dropped_records(case):
    """Each kernel's device time a call is its mean over the records the
    profiler kept times its launches a call: a dropped record takes no
    time from the call and no launch from its count."""
    from l2hmc_torch.utils import kernel_times as kt
    # 50 calls of two kernels of 40 us and 20 us a launch
    kern = {"plaq": (50, 50 * 40.0), "link": (50, 50 * 20.0)}
    if case == "dropped":
        kern["plaq"] = (45, 45 * 40.0)
    got = kt.per_call(kern, 50)
    assert got["device_ms_per_call"] == pytest.approx(0.060)
    assert got["kernels_per_call"] == 2
    assert got["dropped_records"] == (5 if case == "dropped" else 0)
