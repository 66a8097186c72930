"""Parity tests: the flat-state FusedSGHMC path vs the pytree sampler."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from pysgmcmc_tpu.parallel.packed import pad_dim
from pysgmcmc_tpu.samplers.fused import FusedSGHMC
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler


def test_pad_dim():
    assert pad_dim(1) == 128
    assert pad_dim(128) == 128
    assert pad_dim(129) == 256
    assert pad_dim(5252) == 5376


def _quadratic_cost(params):
    return 0.5 * jnp.sum(params["a"] ** 2) + jnp.sum(params["b"] ** 2)


def test_fused_step_matches_xla_path():
    """With identical injected noise, fused math == pytree sampler math."""
    template = {"a": jnp.zeros((3,)), "b": jnp.zeros((2,))}
    n_chains, dim = 4, 5

    key = jax.random.PRNGKey(0)
    positions = {
        "a": jax.random.normal(key, (n_chains, 3)),
        "b": jax.random.normal(jax.random.PRNGKey(1), (n_chains, 2)),
    }

    # XLA reference path: vmapped pytree sampler with captured noise.
    sampler = SGHMCSampler(
        _quadratic_cost, stepsize_schedule=0.01, burn_in_steps=2, mdecay=0.05,
        scale_grad=3.0,
    )
    fused = FusedSGHMC(
        _quadratic_cost, template, stepsize=0.01, burn_in_steps=2,
        mdecay=0.05, scale_grad=3.0,
    )
    state_f = fused.init(positions)

    states_x = jax.vmap(sampler.init)(positions)

    noise_key = jax.random.PRNGKey(42)
    for step_idx in range(4):  # crosses the burn-in boundary at step 2
        noise_key, sub = jax.random.split(noise_key)
        noise_flat = jax.random.normal(sub, (n_chains, dim))

        # drive the fused step with the explicit noise
        state_f, _ = fused.step(state_f, noise=noise_flat)

        # drive the pytree sampler with the same noise injected via the
        # step's noise= parameter (no module-global mutation)
        chain_noise = {
            "a": noise_flat[:, :3],
            "b": noise_flat[:, 3:5],
        }
        states_x, _ = jax.vmap(
            lambda s, eta: sampler.step(s, jax.random.PRNGKey(0), noise=eta)
        )(states_x, chain_noise)

        # compare positions
        theta_x = jnp.concatenate(
            [states_x.position["a"], states_x.position["b"]], axis=1
        )
        np.testing.assert_allclose(
            np.asarray(state_f.theta[:, :dim]), np.asarray(theta_x),
            rtol=1e-6, atol=1e-7,
        )


@pytest.mark.slow
def test_fused_run_converges_to_mode():
    """The full fused run loop: chains started far out move to the
    standard-normal target of the quadratic cost."""
    template = {"x": jnp.zeros((2,))}
    cost_fn = lambda p: 0.5 * jnp.sum(p["x"] ** 2)
    fused = FusedSGHMC(cost_fn, template, stepsize=0.05, burn_in_steps=200)
    n_chains = 64
    positions = {"x": jnp.full((n_chains, 2), 3.0)}
    state = fused.init(positions)
    state, costs = fused.run(state, jax.random.PRNGKey(0), 600)
    draws = np.asarray(state.theta)
    assert abs(draws.mean()) < 0.5
    assert 0.5 < draws.std() < 1.5
    assert np.isfinite(np.asarray(costs)).all()


def test_fused_flatten_roundtrip():
    template = {"w": jnp.zeros((3, 2)), "b": jnp.zeros((2,))}
    fused = FusedSGHMC(lambda p: 0.0, template)
    stacked = {
        "w": jnp.arange(24.0).reshape(4, 3, 2),
        "b": jnp.arange(8.0).reshape(4, 2),
    }
    flat = fused.flatten_positions(stacked)
    assert flat.shape == (4, 8)
    back = fused.unflatten_positions(flat)
    np.testing.assert_array_equal(np.asarray(back["w"]), np.asarray(stacked["w"]))
    np.testing.assert_array_equal(np.asarray(back["b"]), np.asarray(stacked["b"]))


@pytest.mark.slow
def test_fused_run_shared_batches():
    """per_chain_batches=False broadcasts one minibatch to all chains."""
    import numpy as np

    from pysgmcmc_tpu.data_batches import batch_fn as make_batch_fn

    template = {"w": jnp.zeros((2,))}

    def cost_fn(p, batch):
        xb, yb = batch
        return jnp.sum((yb[:, 0] - xb @ p["w"]) ** 2)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(30, 2)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(30,)).astype(np.float32))
    fused = FusedSGHMC(
        cost_fn, template, stepsize=1e-3, burn_in_steps=5,
    )
    state = fused.init({"w": jnp.zeros((4, 2))})
    state, costs = fused.run(
        state, jax.random.PRNGKey(0), 10,
        batch_fn=make_batch_fn(x, y, 5), per_chain_batches=False,
    )
    assert np.isfinite(np.asarray(costs)).all()
