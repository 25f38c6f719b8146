"""The yardstick's operation and byte counts against hand counts."""
from perfbench import flops


def test_u1_force_bytes_and_bound():
    # 512 chains x 2 x 16 x 16 float32: x read, force written, the
    # action (512,) written
    assert flops.u1_force_bytes(512, 16, 16) == (2 * 512 * 512 + 512) * 4
    bound, by = flops.u1_force_bound_s(512, 16, 16)
    assert by == "bytes"
    assert abs(bound - 2099200 / 3.35e12) < 1e-15


def test_parameter_counts_are_the_records():
    u1 = dict(group="U1", latvolume=[16, 16], nleapfrog=4,
              units=[16, 16, 16, 16], batch_norm=True)
    su3 = dict(group="SU3", latvolume=[8, 8, 8, 8], nleapfrog=4,
               units=[32, 32], batch_norm=False)
    assert flops.param_count(u1) == 598344
    assert flops.param_count(su3) == 93131144


def test_u1_network_operations_by_hand():
    spec = dict(group="U1", latvolume=[2, 2], nleapfrog=1, units=[3],
                batch_norm=False)
    # links 8; vnet: (8 + 8) x 3 + 3 x 3 x 8 = 120 weights; xnet:
    # (16 + 8) x 3 + 72 = 144
    assert flops.net_weights(spec, 8, 8, 8) == 120
    assert flops.net_weights(spec, 16, 8, 8) == 144
    # one chain, 2 steps (merged): per step 2 x (2 x 120 + 2 x 144) of the
    # networks, a force (11 x 4 sites), 2 x 10 + 2 x 30 per link on 8
    # links; one force before the first step; H twice (2 x 8 + 6 x 4)
    per_step = 2 * (2 * 120 + 2 * 144) + 44 + 2 * 10 * 8 + 2 * 30 * 8
    assert flops.trajectory_ops(spec, 1, "eval") == 44 + 2 * per_step + 80
    # HMC: 3 forces, 2 steps of 3 x 2 ops on 8 links, H
    assert flops.trajectory_ops(spec, 1, "hmc") == 3 * 44 + 2 * 48 + 80
    train = flops.step_ops(spec, 1, "train")
    assert train == 3 * (44 + 2 * per_step + 80) + 15 * flops.param_count(
        spec)


def test_su3_counts_by_hand():
    spec = dict(group="SU3", latvolume=[1, 1, 1, 1], nleapfrog=1,
                units=[2], batch_norm=False, flow_nsteps=1)
    links = 4
    # a force: 13 products a link; H: 2 x (2 x 8 x 4 + 18 products a site)
    force = 13 * 216 * links
    h = 2 * (2 * 8 * links + 18 * 216)
    assert flops.trajectory_ops(spec, 1, "hmc") == (
        3 * force + 2 * (11 * 216 * links + 4 * 18 * links) + h)
    # one flow step: 3 x (force + exp + product) + projection a link, the
    # plaquettes of a site; then the clover charge's 75 products a site
    assert flops.flow_ops(spec, 1, 1) == 216 * ((3 * 24 + 12) * links + 18
                                                + 75)
