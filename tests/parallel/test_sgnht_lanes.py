"""SGNHT on the chains-on-lanes driver: moments and the thermostat.

The update's parity with :class:`pysgmcmc_tpu.samplers.sgnht.SGNHTSampler`
is pinned in ``tests/parallel/test_packed.py``; here the driver must
thread the per-chain thermostat through the scan and sample the target.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pysgmcmc_tpu.parallel.packed import sample_chain_lanes
from pysgmcmc_tpu.samplers.sgnht import SGNHTSampler


def _cost(p, b=None):
    return 0.5 * sum(jnp.sum(x**2) for x in jax.tree_util.tree_leaves(p))


def test_lanes_sgnht_samples_gaussian():
    """The lanes driver with SGNHT matches target moments
    and threads the thermostat through the scan."""
    sampler = SGNHTSampler(_cost, stepsize_schedule=0.05)
    n = 16
    template = {"x": jnp.zeros(4), "y": jnp.zeros((2, 3))}
    positions = jax.tree_util.tree_map(
        lambda l: 0.1 * jax.random.normal(
            jax.random.PRNGKey(3), (n,) + l.shape), template)
    states = jax.vmap(lambda p, k: sampler.init(p, k))(
        positions, jax.random.split(jax.random.PRNGKey(4), n))

    run = jax.jit(lambda s, k: sample_chain_lanes(
        sampler, s, k, 400, keep_every=5, compute_dtype=None))
    states, positions, costs = run(states, jax.random.PRNGKey(6))
    draws = np.concatenate([
        np.asarray(l)[:, 100:].reshape(-1)
        for l in jax.tree_util.tree_leaves(positions)
    ])
    assert np.isfinite(draws).all()
    assert abs(draws.mean()) < 0.1
    assert abs(draws.std() - 1.0) < 0.15
    assert int(states.step[0]) == 400 * 5
    xi = np.asarray(states.xi)
    assert xi.shape == (n,)
    # the thermostat moved off its initial value and stayed near its
    # stationary mean (= mdecay analog ~ A for an exact gradient)
    assert np.unique(xi).size > 1
    assert np.isfinite(xi).all()
