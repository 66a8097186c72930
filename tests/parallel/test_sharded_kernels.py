"""Mesh composition of the packed lanes drivers.

The lanes drivers must compose with a device mesh: the whole driver body
(gradient, pack, update) runs SPMD per device over its local chains via
``shard_map``, here on the 8-device virtual CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.parallel.mesh import chain_mesh, multihost_mesh
from pysgmcmc_tpu.parallel.packed import (
    burnin_chain_lanes,
    sample_chain_lanes,
)
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler


def _quad_cost(p, b):
    return 0.5 * sum(jnp.sum(x**2) for x in jax.tree_util.tree_leaves(p))


def _states(sampler, n, seed=0):
    rng = np.random.RandomState(seed)
    positions = {
        "x": jnp.asarray(rng.standard_normal((n, 4)), jnp.float32),
        "y": jnp.asarray(rng.standard_normal((n, 2, 3)), jnp.float32),
    }
    return jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(seed), n))


def _n_devices_of(costs):
    return len({s.device for s in costs.addressable_shards})


def test_lanes_sharded_runs_deterministic_and_sharded():
    mesh = chain_mesh()
    n_dev = mesh.devices.size
    n = 2 * n_dev
    sampler = SGHMCSampler(
        _quad_cost, stepsize_schedule=0.05, burn_in_steps=0,
        scale_grad=10.0)
    states = _states(sampler, n)

    def run():
        return jax.jit(lambda s, k: sample_chain_lanes(
            sampler, s, k, 3, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=2, compute_dtype=None, mesh=mesh,
        ))(states, jax.random.PRNGKey(1))

    out_states, positions, costs = run()
    assert costs.shape == (n, 3)
    assert np.isfinite(np.asarray(costs)).all()
    for leaf in jax.tree_util.tree_leaves(positions):
        assert np.isfinite(np.asarray(leaf)).all()
        assert leaf.shape[:2] == (n, 3)
    # outputs genuinely sharded over every device
    assert _n_devices_of(costs) == n_dev
    assert int(np.asarray(out_states.step)[0]) == 6

    # deterministic: an identical second run reproduces bitwise
    _, positions2, costs2 = run()
    np.testing.assert_array_equal(np.asarray(costs), np.asarray(costs2))
    np.testing.assert_array_equal(
        np.asarray(positions["x"]), np.asarray(positions2["x"]))

    # shards draw decorrelated streams: no two chains identical
    flat = np.asarray(positions["x"]).reshape(n, -1)
    assert len({tuple(row) for row in flat}) == n


def test_lanes_sharded_statistics_match_unsharded():
    """Sharded and unsharded lanes runs target the same distribution."""
    mesh = chain_mesh()
    n = 4 * mesh.devices.size
    sampler = SGHMCSampler(
        _quad_cost, stepsize_schedule=0.2, burn_in_steps=0,
        scale_grad=1.0)
    states = _states(sampler, n, seed=3)

    def moments(mesh_arg, key):
        _, positions, _ = jax.jit(lambda s, k: sample_chain_lanes(
            sampler, s, k, 60, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=2, compute_dtype=None, mesh=mesh_arg,
        ))(states, key)
        draws = np.concatenate([
            np.asarray(l)[:, 20:].ravel()
            for l in jax.tree_util.tree_leaves(positions)])
        return draws.mean(), draws.std()

    m_ref, s_ref = moments(None, jax.random.PRNGKey(4))
    m_got, s_got = moments(mesh, jax.random.PRNGKey(4))
    assert abs(m_ref - m_got) < 0.1
    assert abs(s_ref - s_got) < 0.15


def test_burnin_sharded_runs_and_adapts():
    mesh = chain_mesh()
    n = 2 * mesh.devices.size
    sampler = SGHMCSampler(
        _quad_cost, stepsize_schedule=0.05, burn_in_steps=100,
        scale_grad=10.0)
    states = _states(sampler, n, seed=5)

    out = jax.jit(lambda s, k: burnin_chain_lanes(
        sampler, s, k, 20, batch_fn=lambda kk: jnp.zeros(()),
        compute_dtype=None, mesh=mesh,
    ))(states, jax.random.PRNGKey(6))

    assert int(np.asarray(out.step)[0]) == 20
    tau = np.concatenate([
        np.asarray(l).ravel()
        for l in jax.tree_util.tree_leaves(out.stats.tau)])
    assert np.isfinite(tau).all() and (tau > 1.0).all()
    minv = np.concatenate([
        np.asarray(l).ravel()
        for l in jax.tree_util.tree_leaves(out.stats.minv)])
    assert np.isfinite(minv).all() and (minv > 0).all()
    pos0 = jax.tree_util.tree_leaves(out.position)[0]
    assert _n_devices_of(pos0) == mesh.devices.size


def test_lanes_sharded_2d_multihost_mesh():
    """The 2-D (hosts x chips) mesh composes with the lanes driver too."""
    if len(jax.devices()) % 2:
        pytest.skip("needs an even device count")
    mesh = multihost_mesh(n_hosts=2)
    n = 2 * mesh.devices.size
    sampler = SGHMCSampler(
        _quad_cost, stepsize_schedule=0.05, burn_in_steps=0,
        scale_grad=10.0)
    states = _states(sampler, n, seed=8)

    _, positions, costs = jax.jit(lambda s, k: sample_chain_lanes(
        sampler, s, k, 2, batch_fn=lambda kk: jnp.zeros(()),
        keep_every=1, compute_dtype=None, mesh=mesh,
    ))(states, jax.random.PRNGKey(9))
    assert np.isfinite(np.asarray(costs)).all()
    assert _n_devices_of(costs) == mesh.devices.size


def test_sharded_rejects_indivisible_chains():
    mesh = chain_mesh()
    n = mesh.devices.size + 1
    sampler = SGHMCSampler(
        _quad_cost, stepsize_schedule=0.05, burn_in_steps=0)
    states = _states(sampler, n)
    with pytest.raises(ValueError, match="divisible"):
        sample_chain_lanes(
            sampler, states, jax.random.PRNGKey(0), 1,
            batch_fn=lambda kk: jnp.zeros(()), mesh=mesh)
