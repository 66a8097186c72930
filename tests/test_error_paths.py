"""Error-path and small-branch tests surfaced by the coverage lane:
constructor validation, driver guard rails, ``__repr__``s, and the
multi-input dense-network apply branch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.data_batches import generate_batches
from pysgmcmc_tpu.models.architectures import dense_network
from pysgmcmc_tpu.parallel.chains import run_chains, stack_positions
from pysgmcmc_tpu.parallel.mesh import chain_mesh
from pysgmcmc_tpu.samplers._adaptive import update_stats
from pysgmcmc_tpu.samplers.base import sample_chain
from pysgmcmc_tpu.samplers.psgld import PSGLDSampler
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler
from pysgmcmc_tpu.samplers.svgd import SVGDSampler
from pysgmcmc_tpu.stepsize_schedules import (
    ConstantStepsizeSchedule,
    CyclicalStepsizeSchedule,
    PolynomialDecaySchedule,
    TracedStepsizeSchedule,
)
from pysgmcmc_tpu.utils.sample_store import SampleStore


def _cost(x):
    return 0.5 * jnp.sum(x**2)


def test_schedule_strs():
    assert "0.01" in str(ConstantStepsizeSchedule(0.01))
    assert "initial=0.1" in str(TracedStepsizeSchedule(0.1))
    assert "gamma" in str(PolynomialDecaySchedule(a=1.0, b=2.0, gamma=0.55))
    assert "cycle_length" in str(
        CyclicalStepsizeSchedule(0.1, cycle_length=100))


def test_run_chains_empty_pytree_raises():
    sampler = SGHMCSampler(_cost, burn_in_steps=1)
    with pytest.raises(ValueError, match="empty"):
        run_chains(sampler, {}, jax.random.PRNGKey(0), 2)


def test_stack_positions_jitter_requires_key():
    with pytest.raises(ValueError, match="PRNG key"):
        stack_positions(jnp.zeros(3), 4, jitter=0.1)


def test_run_chains_mesh_divisibility():
    sampler = SGHMCSampler(_cost, burn_in_steps=1)
    positions = stack_positions(jnp.zeros(3), 3)  # 3 chains, 8 devices
    with pytest.raises(ValueError, match="divisible"):
        run_chains(sampler, positions, jax.random.PRNGKey(0), 2,
                   mesh=chain_mesh())


def test_sample_chain_keep_every_validation():
    sampler = SGHMCSampler(_cost, burn_in_steps=1)
    state = sampler.init(jnp.zeros(3), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="keep_every"):
        sample_chain(sampler, state, jax.random.PRNGKey(1), 2, keep_every=0)


def test_update_stats_bad_phase():
    stats = (jnp.ones(2), jnp.ones(2), jnp.ones(2), jnp.ones(2))
    with pytest.raises(ValueError, match="phase"):
        update_stats(stats, jnp.zeros(2), jnp.asarray(0), phase="warmup")


def test_svgd_ctor_validation():
    with pytest.raises(ValueError, match="alpha"):
        SVGDSampler(_cost, alpha="a lot")
    with pytest.raises(ValueError, match="fudge_factor"):
        SVGDSampler(_cost, fudge_factor=None)
    with pytest.raises(ValueError, match="kernel_impl"):
        SVGDSampler(_cost, kernel_impl="magic")


def test_svgd_step_with_batch():
    def batched_cost(x, batch):
        return 0.5 * jnp.sum((x - jnp.mean(batch)) ** 2)

    svgd = SVGDSampler(batched_cost, stepsize_schedule=0.05)
    particles = jax.random.normal(jax.random.PRNGKey(0), (8, 2))
    state = svgd.init(particles, jax.random.PRNGKey(1))
    batch = jnp.ones((4,))
    state, info = svgd.step(state, jax.random.PRNGKey(2), batch=batch)
    assert state.position.shape == (8, 2)
    assert info.cost.shape == (8,)
    assert bool(np.isfinite(np.asarray(info.cost)).all())


def test_psgld_ctor_validation_and_prior_fold():
    with pytest.raises(ValueError, match="alpha"):
        PSGLDSampler(_cost, alpha=1.5)

    # the folded Gaussian prior enters the gradient: with everything else
    # identical (same keys), a nonzero prior scale must change the
    # trajectory, deterministically
    key = jax.random.PRNGKey(0)
    theta0 = jnp.full((4,), 5.0)

    def one_step(prior_scale):
        sampler = PSGLDSampler(
            _cost, stepsize_schedule=1e-3,
            gaussian_prior_scale=prior_scale,
        )
        state = sampler.init(theta0, key)
        state, _ = sampler.step(state, key=jax.random.PRNGKey(1))
        return np.asarray(state.position)

    with_prior = one_step(100.0)
    np.testing.assert_array_equal(with_prior, one_step(100.0))
    assert not np.array_equal(with_prior, one_step(0.0))


def test_generate_batches_seed_validation_and_default():
    x = np.arange(20.0).reshape(10, 2)
    y = np.arange(10.0)
    with pytest.raises(AssertionError, match="seed"):
        next(generate_batches(x, y, batch_size=4, seed=1.5))
    xb, yb = next(generate_batches(x, y, batch_size=4))  # seed=None path
    assert xb.shape == (4, 2)
    assert yb.shape == (4, 1)


def test_sample_store_single_row_and_default_count():
    store = SampleStore(capacity=8, width=3)
    store.append(np.arange(3.0, dtype=np.float32))  # 1-D row promoted
    store.append(np.ones((2, 3), dtype=np.float32))
    assert len(store) == 3
    got = store.get(start=1)  # count defaults to the remainder
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got, np.ones((2, 3), np.float32))


def test_dense_network_multi_input_apply():
    init_fn, apply_fn = dense_network(3)
    params = init_fn(jax.random.PRNGKey(0))
    out = apply_fn(params, jnp.ones((5, 3)))
    assert out.shape == (5, 2)
    assert bool(np.isfinite(np.asarray(out)).all())


def test_sample_chain_lanes_driver_validation():
    from pysgmcmc_tpu.parallel.packed import sample_chain_lanes
    from pysgmcmc_tpu.samplers.svgd import SVGDSampler

    svgd = SVGDSampler(_cost)
    state = svgd.init(jnp.zeros((4, 3)), jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="SGNHT"):
        sample_chain_lanes(svgd, state, jax.random.PRNGKey(1), 1)

    sghmc = SGHMCSampler(_cost, burn_in_steps=1)
    states = jax.vmap(sghmc.init)(
        jnp.zeros((4, 3)), jax.random.split(jax.random.PRNGKey(2), 4))
    # the backend option went with the hand-written kernels
    with pytest.raises(TypeError, match="backend"):
        sample_chain_lanes(
            sghmc, states, jax.random.PRNGKey(3), 1, backend="xla")


def test_burnin_chain_lanes_rejects_non_adaptive():
    from pysgmcmc_tpu.parallel.packed import burnin_chain_lanes
    from pysgmcmc_tpu.samplers.sgnht import SGNHTSampler

    sgnht = SGNHTSampler(_cost)
    states = jax.vmap(sgnht.init)(
        jnp.zeros((2, 3)), jax.random.split(jax.random.PRNGKey(0), 2))
    with pytest.raises(NotImplementedError, match="adaptive"):
        burnin_chain_lanes(sgnht, states, jax.random.PRNGKey(1), 2)


def test_burnin_chain_lanes_zero_steps_noop():
    from pysgmcmc_tpu.parallel.packed import burnin_chain_lanes

    sghmc = SGHMCSampler(_cost, burn_in_steps=1)
    states = jax.vmap(sghmc.init)(
        jnp.ones((2, 3)), jax.random.split(jax.random.PRNGKey(0), 2))
    out = burnin_chain_lanes(sghmc, states, jax.random.PRNGKey(1), 0,
                             compute_dtype=None)
    for a, b in zip(jax.tree_util.tree_leaves(states),
                    jax.tree_util.tree_leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
