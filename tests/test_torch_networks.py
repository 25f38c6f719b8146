"""The port's LeapfrogLayer, built from converted JAX weights, against
`apply_leapfrog_layer` at float64 (to 1e-12: the same GEMMs and
elementwise ops)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_torch.models import networks as tnet
from l2hmc_tpu.configs import ConvolutionConfig, NetWeight, NetworkConfig
from l2hmc_tpu.models import networks as jnet
from torch_parity import params_to_numpy

torch.set_num_threads(1)

NB, XD, VD, OD = 12, 20, 10, 10
TOL = 1e-12


def _setup(use_bn=True, dropout=0.2, act="leaky_relu", **cfg_kw):
    cfg = NetworkConfig(units=[8, 6], activation_fn=act,
                        dropout_prob=dropout, use_batch_norm=use_bn, **cfg_kw)
    params = jnet.init_leapfrog_layer(jax.random.PRNGKey(0), x_dim=XD,
                                      v_dim=VD, out_dim=OD, cfg=cfg,
                                      dtype=jnp.float64)
    if use_bn:
        # non-trivial running statistics, so eval mode is tested for real
        rng = np.random.default_rng(9)
        params["bn"]["r_mean"] = jnp.asarray(rng.normal(size=6))
        params["bn"]["r_var"] = jnp.asarray(rng.uniform(0.5, 2.0, size=6))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(NB, XD))
    v = rng.normal(size=(NB, VD))
    return cfg, params, x, v


def _compare(touts, jouts):
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("act", ["leaky_relu", "tanh", "gelu"])
def test_train_mode_batch_bn_injected_dropout(act):
    cfg, params, x, v = _setup(act=act)
    nw = NetWeight(s=0.7, t=1.0, q=1.3)
    dkey = jax.random.PRNGKey(5)
    js, jt, jq, jbn = jnet.apply_leapfrog_layer(
        params, jnp.asarray(x), jnp.asarray(v), cfg=cfg, net_weight=nw,
        training=True, dropout_key=dkey, collect_bn=True)
    mask = np.asarray(jax.random.bernoulli(dkey, 0.8, (NB, 6)))
    layer = tnet.from_jax_params(params_to_numpy(params), cfg, nw)
    ts, tt, tq, tbn = layer(torch.from_numpy(x), torch.from_numpy(v),
                            training=True,
                            dropout_mask=torch.from_numpy(np.array(mask)),
                            collect_bn=True)
    _compare((ts, tt, tq, *tbn), (js, jt, jq, *jbn))


def test_eval_mode_running_bn():
    cfg, params, x, v = _setup()
    nw = NetWeight()
    jout = jnet.apply_leapfrog_layer(params, jnp.asarray(x), jnp.asarray(v),
                                     cfg=cfg, net_weight=nw, training=False)
    layer = tnet.from_jax_params(params_to_numpy(params), cfg, nw)
    _compare(layer(torch.from_numpy(x), torch.from_numpy(v)), jout)


def test_no_bn_and_zero_heads():
    cfg, params, x, v = _setup(use_bn=False, dropout=0.0,
                               zero_init_heads=True)
    jout = jnet.apply_leapfrog_layer(params, jnp.asarray(x), jnp.asarray(v),
                                     cfg=cfg, net_weight=NetWeight(),
                                     training=True)
    layer = tnet.from_jax_params(params_to_numpy(params), cfg)
    _compare(layer(torch.from_numpy(x), torch.from_numpy(v), training=True),
             jout)
    # the port's own zero_init_heads gives the same all-zero heads
    own = tnet.LeapfrogLayer(XD, VD, OD, cfg, NetWeight(),
                             dtype=torch.float64)
    for head in (own.scale, own.transl, own.transf):
        assert all(float(p.detach().abs().max()) == 0.0
                   for p in head.parameters())


def test_bf16_compute_dtype():
    """bf16 GEMM stack: compared in bf16 working precision (2^-8 relative
    per op over a few layers)."""
    cfg, params, x, v = _setup(dropout=0.0)
    params32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)
    jout = jnet.apply_leapfrog_layer(
        params32, jnp.asarray(x, jnp.float32), jnp.asarray(v, jnp.float32),
        cfg=cfg, net_weight=NetWeight(), training=False,
        compute_dtype=jnp.bfloat16)
    layer = tnet.from_jax_params(params_to_numpy(params32), cfg,
                                 compute_dtype=torch.bfloat16)
    tout = layer(torch.from_numpy(x).float(), torch.from_numpy(v).float())
    for t, j in zip(tout, jout):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=0.1)


def test_conv_not_ported():
    """Once the conv front-end raised; now a tree with a "conv" sub-tree
    converts, given the structure the tree does not carry (config,
    channels, H x W), and is refused without it."""
    cfg, params, _, _ = _setup()
    params["conv"] = {}
    with pytest.raises(ValueError, match="conv"):
        tnet.from_jax_params(params_to_numpy(params), cfg)
    assert ConvolutionConfig(filters=[2]).sizes == [2]


CONVS = {
    "two_layers_pooled": ConvolutionConfig(filters=[3, 2], sizes=[3, 2],
                                           pool=[1, 2]),
    "one_layer": ConvolutionConfig(filters=[2], sizes=[2], pool=[2]),
    "three_layers_pool_one": ConvolutionConfig(filters=[2, 3, 2],
                                               sizes=[2, 3, 1],
                                               pool=[2, 1, 2]),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_front_end_matches(name):
    """Conv stack alone and inside a LeapfrogLayer, from converted
    weights: periodic pad of k-1, VALID conv, max-pool after every second
    layer where pool > 1, activation, linear head; 1e-12."""
    conv = CONVS[name]
    channels, hw = 4, (4, 6)
    xd = channels * hw[0] * hw[1]
    cfg = NetworkConfig(units=[8, 6], activation_fn="leaky_relu",
                        dropout_prob=0.0, use_batch_norm=True)
    params = jnet.init_leapfrog_layer(
        jax.random.PRNGKey(2), x_dim=xd, v_dim=VD, out_dim=OD, cfg=cfg,
        conv=conv, conv_channels=channels, conv_hw=hw, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    x, v = rng.normal(size=(NB, xd)), rng.normal(size=(NB, VD))
    layer = tnet.from_jax_params(params_to_numpy(params), cfg, conv=conv,
                                 conv_channels=channels, conv_hw=hw)
    jstack = jnet.apply_conv_stack(
        params["conv"], jnp.asarray(x), jnet.ACTIVATIONS["leaky_relu"], conv,
        channels, hw)
    _compare([layer.conv(torch.from_numpy(x), layer.act)], [jstack])
    jout = jnet.apply_leapfrog_layer(
        params, jnp.asarray(x), jnp.asarray(v), cfg=cfg,
        net_weight=NetWeight(), training=True, conv=conv,
        conv_channels=channels, conv_hw=hw)
    _compare(layer(torch.from_numpy(x), torch.from_numpy(v), training=True),
             jout)
    # the port's own construction has the reference's shapes
    own = tnet.LeapfrogLayer(xd, VD, OD, cfg, NetWeight(),
                             dtype=torch.float64, conv=conv,
                             conv_channels=channels, conv_hw=hw)
    for a, b in zip(own.conv.parameters(), layer.conv.parameters()):
        assert a.shape == b.shape
    assert own.conv.head.out_features == xd


def test_conv_u1_transition_matches():
    """One U(1) apply_transition_fb with the conv front-end on the x
    networks (never on the v network), against the reference: 1e-10."""
    from l2hmc_tpu.configs import DynamicsConfig
    from l2hmc_tpu.models.dynamics import Dynamics
    from torch_parity import fb_draws, port_dynamics, to_torch
    cfg = DynamicsConfig(nchains=6, group="U1", latvolume=[4, 4],
                         nleapfrog=2, eps=0.1)
    netcfg = NetworkConfig(units=[8], activation_fn="tanh",
                           dropout_prob=0.0, use_batch_norm=False)
    conv = ConvolutionConfig(filters=[3, 2], sizes=[3, 3], pool=[1, 2])
    dyn = Dynamics(cfg, netcfg, conv=conv, dtype=jnp.float64)
    params, masks = dyn.init_params(jax.random.PRNGKey(0))
    tdyn = port_dynamics(dyn, params, masks)
    assert tdyn.vnets[0].conv is None
    assert tdyn.xnets_first[1].conv is not None
    assert tdyn.xnets_second[0].conv is not None
    x = dyn.random_x(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    jx, jm = dyn.apply_transition_fb(params, masks, x, 2.5, key)
    tx, tm = tdyn.apply_transition_fb(to_torch(x), 2.5,
                                      **fb_draws(dyn, x, key))
    for t, j in ((tm["mc_states"].proposed.x, jm["mc_states"].proposed.x),
                 (tm["sumlogdet"], jm["sumlogdet"]), (tm["acc"], jm["acc"]),
                 (tx, jx)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-10, rtol=0)
