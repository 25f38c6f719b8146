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
