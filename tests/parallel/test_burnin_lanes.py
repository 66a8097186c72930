"""Burn-in update of the packed drivers + per-chain stepsize support.

The self-tuning burn-in update
(:func:`pysgmcmc_tpu.parallel.packed.adaptive_burnin_update`) must match
the pytree adaptive step given identical noise (tau/minv bitwise; the
mul-add-bearing outputs to 1-2 ulp of FMA-contraction freedom), the
chains-on-lanes drivers must support genuinely per-chain stepsizes (the
ESS-sweep pattern), and the shared-stepsize drivers must refuse
heterogeneous per-chain schedule state instead of silently collapsing it
to chain 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.parallel.packed import (
    adaptive_burnin_update,
    burnin_chain_lanes,
    make_lanes_spec,
    make_pack_spec,
    pack_lanes,
    pack_tree,
    sample_chain_lanes,
    sample_chain_stacked,
    sghmc_update,
    unpack_lanes,
    unpack_tree,
)
from pysgmcmc_tpu.samplers.base import sample_chain
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler
from pysgmcmc_tpu.samplers.sgld import SGLDSampler
from pysgmcmc_tpu.stepsize_schedules import TracedStepsizeSchedule
from pysgmcmc_tpu.utils.pytree import normal_like_tree


def _template():
    # small leaves: the parity is shape-independent
    return {
        "W1": jnp.zeros((1, 12)), "b1": jnp.zeros(12),
        "W2": jnp.zeros((12, 12)), "b2": jnp.zeros(12),
    }


def _quad_cost(p, b):
    return 0.5 * sum(jnp.sum(x**2) for x in jax.tree_util.tree_leaves(p))


def _adapted_states(sampler, n, seed=0, steps=3):
    """Fresh init + a few pytree burn-in steps so the EMAs are non-trivial."""
    rng = np.random.RandomState(seed)
    positions = jax.tree_util.tree_map(
        lambda l: jnp.asarray(rng.standard_normal((n,) + l.shape),
                              jnp.float32), _template())
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(seed), n))
    states, _ = jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 1, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=steps, collect_costs=False, phase="burn_in")
    )(states, jax.random.split(jax.random.PRNGKey(seed + 1), n))
    return states


def test_sghmc_burnin_kernel_matches_pytree_bitwise():
    """Given identical noise, the packed burn-in update == the adaptive
    pytree step: position, momentum and every EMA statistic."""
    sampler = SGHMCSampler(
        _quad_cost, stepsize_schedule=0.05, burn_in_steps=100,
        scale_grad=10.0, gaussian_prior_scale=0.125,
    )
    n = 3
    states = _adapted_states(sampler, n)
    spec = make_pack_spec(_template())

    eta = jax.vmap(normal_like_tree, in_axes=(0, 0))(
        jax.random.split(jax.random.PRNGKey(2), n), states.position)
    ref_state, _ = jax.vmap(
        lambda s, e: sampler.step(
            s, jax.random.PRNGKey(0), jnp.zeros(()), noise=e,
            phase="burn_in")
    )(states, eta)

    grads = jax.vmap(jax.grad(sampler.cost_fn))(
        states.position, jnp.zeros((n,)))
    outs = adaptive_burnin_update(
        pack_tree(spec, states.position),
        pack_tree(spec, states.momentum),
        pack_tree(spec, states.stats.tau),
        pack_tree(spec, states.stats.g),
        pack_tree(spec, states.stats.v_hat),
        pack_tree(spec, grads), jnp.float32(0.05), pack_tree(spec, eta),
        sampler.scale_grad, sampler.gaussian_prior_scale,
        mdecay=sampler.mdecay,
    )
    got = {
        "position": unpack_tree(spec, outs[0]),
        "momentum": unpack_tree(spec, outs[1]),
        "tau": unpack_tree(spec, outs[2]),
        "g": unpack_tree(spec, outs[3]),
        "v_hat": unpack_tree(spec, outs[4]),
        "minv": unpack_tree(spec, outs[5]),
    }
    ref = {
        "position": ref_state.position,
        "momentum": ref_state.momentum,
        "tau": ref_state.stats.tau,
        "g": ref_state.stats.g,
        "v_hat": ref_state.stats.v_hat,
        "minv": ref_state.stats.minv,
    }
    # tau and minv involve no fusable mul-add chains and match bitwise;
    # the remaining outputs are identical up to 1-2 ulp of FMA-contraction
    # freedom between the two compiled programs
    for name in ref:
        for a, b in zip(jax.tree_util.tree_leaves(ref[name]),
                        jax.tree_util.tree_leaves(got[name])):
            if name in ("tau", "minv"):
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b), err_msg=name)
            else:
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-8,
                    err_msg=name)


def test_sgld_burnin_kernel_matches_pytree_bitwise():
    sampler = SGLDSampler(
        _quad_cost, stepsize_schedule=0.01, burn_in_steps=100,
        scale_grad=10.0, gaussian_prior_scale=0.125,
    )
    n = 3
    states = _adapted_states(sampler, n, seed=7)
    spec = make_pack_spec(_template())

    eta = jax.vmap(normal_like_tree, in_axes=(0, 0))(
        jax.random.split(jax.random.PRNGKey(3), n), states.position)
    ref_state, _ = jax.vmap(
        lambda s, e: sampler.step(
            s, jax.random.PRNGKey(0), jnp.zeros(()), noise=e,
            phase="burn_in")
    )(states, eta)

    grads = jax.vmap(jax.grad(sampler.cost_fn))(
        states.position, jnp.zeros((n,)))
    outs = adaptive_burnin_update(
        pack_tree(spec, states.position), None,
        pack_tree(spec, states.stats.tau),
        pack_tree(spec, states.stats.g),
        pack_tree(spec, states.stats.v_hat),
        pack_tree(spec, grads), jnp.float32(0.01), pack_tree(spec, eta),
        sampler.scale_grad, sampler.gaussian_prior_scale, a_coef=sampler.A,
    )
    got = {
        "position": unpack_tree(spec, outs[0]),
        "tau": unpack_tree(spec, outs[2]),
        "g": unpack_tree(spec, outs[3]),
        "v_hat": unpack_tree(spec, outs[4]),
        "minv": unpack_tree(spec, outs[5]),
    }
    ref = {
        "position": ref_state.position,
        "tau": ref_state.stats.tau,
        "g": ref_state.stats.g,
        "v_hat": ref_state.stats.v_hat,
        "minv": ref_state.stats.minv,
    }
    # tau and minv involve no fusable mul-add chains and match bitwise;
    # the remaining outputs are identical up to 1-2 ulp of FMA-contraction
    # freedom between the two compiled programs
    for name in ref:
        for a, b in zip(jax.tree_util.tree_leaves(ref[name]),
                        jax.tree_util.tree_leaves(got[name])):
            if name in ("tau", "minv"):
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b), err_msg=name)
            else:
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-8,
                    err_msg=name)


@pytest.mark.parametrize("kind", ["sghmc", "sgld"])
def test_burnin_chain_lanes_driver(kind):
    """The burn-in lanes driver adapts the EMAs sanely."""
    if kind == "sghmc":
        sampler = SGHMCSampler(
            _quad_cost, stepsize_schedule=0.05, burn_in_steps=1000,
            scale_grad=10.0)
    else:
        sampler = SGLDSampler(
            _quad_cost, stepsize_schedule=0.01, burn_in_steps=1000,
            scale_grad=10.0)
    n = 8
    rng = np.random.RandomState(0)
    positions = jax.tree_util.tree_map(
        lambda l: jnp.asarray(rng.standard_normal((n,) + l.shape),
                              jnp.float32), _template())
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(0), n))

    run = jax.jit(lambda s, k: burnin_chain_lanes(
        sampler, s, k, 50, batch_fn=lambda kk: jnp.zeros(()),
        compute_dtype=None))
    out = run(states, jax.random.PRNGKey(1))

    assert int(out.step[0]) == 50
    for leaf in jax.tree_util.tree_leaves(out.position):
        assert np.isfinite(np.asarray(leaf)).all()
    minv = np.concatenate([
        np.asarray(l).ravel()
        for l in jax.tree_util.tree_leaves(out.stats.minv)])
    assert np.isfinite(minv).all()
    assert (minv > 0).all()
    # the EMAs actually adapted away from their tau = g = v_hat = 1 init
    tau = np.concatenate([
        np.asarray(l).ravel()
        for l in jax.tree_util.tree_leaves(out.stats.tau)])
    assert (tau > 1.0).all()


def test_burnin_lanes_pallas_interpret_matches_xla():
    """The burn-in update on the lanes layout (chains on the minor axis,
    128 chains) == the adaptive pytree step, chain for chain."""
    sampler = SGHMCSampler(
        _quad_cost, stepsize_schedule=0.05, burn_in_steps=100,
        scale_grad=10.0)
    n = 128
    template = {"x": jnp.zeros(4), "y": jnp.zeros((2, 3))}
    rng = np.random.RandomState(1)
    positions = {
        k: jnp.asarray(rng.standard_normal((n,) + v.shape), jnp.float32)
        for k, v in template.items()
    }
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(0), n))
    spec = make_lanes_spec(
        jax.tree_util.tree_map(lambda l: l[0], states.position))
    eta = jax.vmap(normal_like_tree)(
        jax.random.split(jax.random.PRNGKey(9), n), states.position)
    ref, _ = jax.vmap(
        lambda s, e: sampler.step(
            s, jax.random.PRNGKey(0), jnp.zeros(()), noise=e,
            phase="burn_in")
    )(states, eta)

    grads = jax.vmap(jax.grad(lambda p: _quad_cost(p, None)))(
        states.position)
    outs = adaptive_burnin_update(
        pack_lanes(spec, states.position), pack_lanes(spec, states.momentum),
        pack_lanes(spec, states.stats.tau), pack_lanes(spec, states.stats.g),
        pack_lanes(spec, states.stats.v_hat), pack_lanes(spec, grads),
        jnp.float32(0.05), pack_lanes(spec, eta), sampler.scale_grad,
        mdecay=sampler.mdecay)
    want = (ref.position, ref.momentum, ref.stats.tau, ref.stats.g,
            ref.stats.v_hat, ref.stats.minv)
    for got, ref_tree in zip(outs, want):
        for a, b in zip(jax.tree_util.tree_leaves(ref_tree),
                        jax.tree_util.tree_leaves(unpack_lanes(spec, got))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_slim_update_per_chain_eps_row_matches_scalar():
    """A per-chain eps row in the lanes update == per-chain scalar runs,
    column for column."""
    n = 128
    rows = 16
    rng = np.random.RandomState(2)

    def arr():
        return jnp.asarray(rng.standard_normal((rows, n)), jnp.float32)

    theta, v, grad = arr(), arr(), arr()
    minv = jnp.abs(arr()) + 0.1
    eta = arr()
    eps_a, eps_b = 0.05, 0.002
    kw = dict(mdecay=0.05, scale_grad=10.0, prior_scale=0.125)

    ta, va = sghmc_update(
        theta, v, grad, minv, jnp.float32(eps_a), eta, **kw)
    tb, vb = sghmc_update(
        theta, v, grad, minv, jnp.float32(eps_b), eta, **kw)
    eps_row = jnp.where(
        jnp.arange(n) < n // 2, jnp.float32(eps_a), jnp.float32(eps_b))
    tc, vc = sghmc_update(theta, v, grad, minv, eps_row[None, :], eta, **kw)

    half = n // 2
    np.testing.assert_array_equal(
        np.asarray(tc)[:, :half], np.asarray(ta)[:, :half])
    np.testing.assert_array_equal(
        np.asarray(tc)[:, half:], np.asarray(tb)[:, half:])
    np.testing.assert_array_equal(
        np.asarray(vc)[:, :half], np.asarray(va)[:, :half])
    np.testing.assert_array_equal(
        np.asarray(vc)[:, half:], np.asarray(vb)[:, half:])


def test_lanes_driver_per_chain_traced_stepsizes():
    """sample_chain_lanes advances each chain at its OWN traced stepsize:
    a mixed run equals the matching homogeneous runs, chain for chain."""
    n = 8
    template = {"x": jnp.zeros(4)}
    eps_a, eps_b = 0.05, 0.002

    def make_states(eps_values):
        sampler = SGHMCSampler(
            _quad_cost, stepsize_schedule=TracedStepsizeSchedule(0.01),
            burn_in_steps=0, scale_grad=10.0)
        rng = np.random.RandomState(3)
        positions = {
            "x": jnp.asarray(rng.standard_normal((n, 4)), jnp.float32)}
        states = jax.vmap(sampler.init)(
            positions, jax.random.split(jax.random.PRNGKey(0), n))
        states = states._replace(
            schedule_state=jnp.asarray(eps_values, jnp.float32))
        return sampler, states

    def run(eps_values):
        sampler, states = make_states(eps_values)
        _, positions, costs = jax.jit(
            lambda s, k: sample_chain_lanes(
                sampler, s, k, 4,
                batch_fn=lambda kk: jnp.zeros(()),
                keep_every=2, compute_dtype=None)
        )(states, jax.random.PRNGKey(5))
        return np.asarray(positions["x"])

    pos_a = run(np.full(n, eps_a))
    pos_b = run(np.full(n, eps_b))
    mixed = np.concatenate([np.full(n // 2, eps_a), np.full(n // 2, eps_b)])
    pos_c = run(mixed)

    half = n // 2
    np.testing.assert_array_equal(pos_c[:half], pos_a[:half])
    np.testing.assert_array_equal(pos_c[half:], pos_b[half:])
    # and the two stepsizes genuinely differ
    assert not np.array_equal(pos_a[half:], pos_b[half:])


def test_shared_drivers_refuse_heterogeneous_schedule_state():
    """The shared-stepsize drivers raise on per-chain traced stepsizes
    instead of silently running every chain at chain 0's stepsize."""
    n = 4
    sampler = SGHMCSampler(
        _quad_cost, stepsize_schedule=TracedStepsizeSchedule(0.01),
        burn_in_steps=0, scale_grad=10.0)
    rng = np.random.RandomState(4)
    positions = {
        "x": jnp.asarray(rng.standard_normal((n, 4)), jnp.float32)}
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(0), n))
    states = states._replace(
        schedule_state=jnp.asarray([0.01, 0.02, 0.03, 0.04], jnp.float32))

    with pytest.raises(ValueError, match="heterogeneous"):
        sample_chain_stacked(
            sampler, states, jax.random.PRNGKey(1), 1,
            batch_fn=lambda kk: jnp.zeros(()))

    # homogeneous stacked state still collapses fine
    states_ok = states._replace(
        schedule_state=jnp.full(n, 0.01, jnp.float32))
    _, positions, _ = sample_chain_stacked(
        sampler, states_ok, jax.random.PRNGKey(1), 1,
        batch_fn=lambda kk: jnp.zeros(()))
    assert np.isfinite(np.asarray(positions["x"])).all()
