"""Packed flat sampling-phase path: layout round-trips and math parity.

The packed update rules (``parallel/packed.py``) must match the pytree
samplers' ``step`` given identical noise, and the drivers must be
statistically identical given their own noise stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.parallel.packed import (
    make_pack_spec,
    pack_mask,
    pack_tree,
    sample_chain_packed,
    sghmc_update,
    unpack_tree,
)
from pysgmcmc_tpu.samplers.base import sample_chain
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler
from pysgmcmc_tpu.utils.pytree import normal_like_tree


def _template():
    return {
        "W1": jnp.zeros((1, 50)), "b1": jnp.zeros(50),
        "W2": jnp.zeros((50, 50)), "b2": jnp.zeros(50),
        "W4": jnp.zeros((50, 2)), "b4": jnp.zeros(2),
    }


def test_pack_spec_layout():
    spec = make_pack_spec(_template())
    # every slot 128-aligned, width covers the padded sum
    assert all(off % 128 == 0 for off in spec.offsets)
    assert spec.width % 128 == 0
    assert spec.width == 128 + 128 + 2560 + 128 + 128 + 128


def test_pack_unpack_roundtrip():
    spec = make_pack_spec(_template())
    rng = np.random.RandomState(0)
    stacked = jax.tree_util.tree_map(
        lambda l: jnp.asarray(rng.standard_normal((4,) + l.shape),
                              jnp.float32),
        _template(),
    )
    flat = pack_tree(spec, stacked)
    assert flat.shape == (4, spec.width)
    out = unpack_tree(spec, flat)
    for a, b in zip(jax.tree_util.tree_leaves(stacked),
                    jax.tree_util.tree_leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # slot padding is zero
    mask = np.asarray(pack_mask(spec))[0]
    assert np.all(np.asarray(flat)[:, mask == 0] == 0)


def test_slim_update_matches_pytree_step_bitwise():
    """Given identical noise, the slot-packed SGHMC update ==
    SGHMCSampler.step."""
    template = {
        "W1": jnp.zeros((1, 12)), "b1": jnp.zeros(12),
        "W2": jnp.zeros((12, 12)), "b2": jnp.zeros(12),
    }
    spec = make_pack_spec(template)
    rng = np.random.RandomState(1)
    n = 3

    def rand_tree(scale=1.0):
        return jax.tree_util.tree_map(
            lambda l: jnp.asarray(
                scale * rng.standard_normal((n,) + l.shape), jnp.float32),
            template,
        )

    positions = rand_tree()
    sampler = SGHMCSampler(
        lambda p, b: 0.5 * sum(jnp.sum(x**2) for x in
                               jax.tree_util.tree_leaves(p)),
        stepsize_schedule=0.05, burn_in_steps=2, scale_grad=10.0,
        gaussian_prior_scale=0.125,
    )
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(0), n)
    )
    # run burn-in so minv is adapted and frozen
    states, _ = jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 1, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=2, collect_costs=False, phase="burn_in")
    )(states, jax.random.split(jax.random.PRNGKey(1), n))

    eta = jax.vmap(normal_like_tree, in_axes=(0, 0))(
        jax.random.split(jax.random.PRNGKey(2), n), states.position
    )

    # pytree reference step with injected noise
    ref_state, _ = jax.vmap(
        lambda s, e: sampler.step(
            s, jax.random.PRNGKey(0), jnp.zeros(()), noise=e,
            phase="sampling")
    )(states, eta)

    # packed step with the same noise packed
    theta = pack_tree(spec, states.position)
    v = pack_tree(spec, states.momentum)
    minv = pack_tree(spec, states.stats.minv)
    eta_flat = pack_tree(spec, eta)
    theta2, v2 = sghmc_update(
        theta, v,
        pack_tree(spec, jax.vmap(jax.grad(sampler.cost_fn))(
            states.position, jnp.zeros((n,)))),
        minv, jnp.float32(0.05), eta_flat,
        sampler.mdecay, sampler.scale_grad, sampler.gaussian_prior_scale,
    )
    got_pos = unpack_tree(spec, theta2)
    got_mom = unpack_tree(spec, v2)
    for a, b in zip(jax.tree_util.tree_leaves(ref_state.position),
                    jax.tree_util.tree_leaves(got_pos)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(ref_state.momentum),
                    jax.tree_util.tree_leaves(got_mom)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=1e-6)


def _gaussian_sampler(**kwargs):
    # standard normal target: cost = 0.5 ||x||^2 (ignores the batch)
    defaults = dict(stepsize_schedule=0.1, burn_in_steps=100, mdecay=0.05)
    defaults.update(kwargs)
    return SGHMCSampler(
        lambda p, b: 0.5 * sum(jnp.sum(x**2) for x in
                               jax.tree_util.tree_leaves(p)),
        **defaults,
    )


@pytest.mark.slow
def test_packed_chain_samples_gaussian():
    """The packed driver's draws match the target's first two moments."""
    sampler = _gaussian_sampler()
    n = 16
    template = {"x": jnp.zeros(4), "y": jnp.zeros((2, 3))}
    positions = jax.tree_util.tree_map(
        lambda l: 0.1 * jax.random.normal(
            jax.random.PRNGKey(3), (n,) + l.shape), template)
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(4), n))
    states, _ = jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 1, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=100, collect_costs=False, phase="burn_in")
    )(states, jax.random.split(jax.random.PRNGKey(5), n))

    run = jax.jit(lambda s, k: sample_chain_packed(
        sampler, s, k, 400, batch_fn=lambda kk: jnp.zeros(()),
        keep_every=5, compute_dtype=None))
    states, positions, costs = run(states, jax.random.PRNGKey(6))
    draws = np.concatenate([
        np.asarray(l).reshape(-1)
        for l in jax.tree_util.tree_leaves(positions)
    ])
    assert np.isfinite(draws).all()
    assert abs(draws.mean()) < 0.1
    assert abs(draws.std() - 1.0) < 0.15
    assert costs.shape == (n, 400)


def test_packed_updates_state_bookkeeping():
    sampler = _gaussian_sampler(burn_in_steps=0)
    n = 4
    template = {"x": jnp.zeros(3)}
    positions = jax.tree_util.tree_map(
        lambda l: jnp.ones((n,) + l.shape), template)
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(0), n))
    new_states, pos, costs = jax.jit(
        lambda s, k: sample_chain_packed(
            sampler, s, k, 3, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=2, compute_dtype=None)
    )(states, jax.random.PRNGKey(1))
    assert int(new_states.step[0]) == 6
    assert costs.shape == (n, 3)
    assert pos["x"].shape == (n, 3, 3)
    # final collected position == final state position
    np.testing.assert_array_equal(
        np.asarray(pos["x"][:, -1]), np.asarray(new_states.position["x"]))


@pytest.mark.slow
@pytest.mark.parametrize("bf16_params", [False, True])
def test_stacked_chain_samples_gaussian(bf16_params):
    """The stacked driver matches the target's moments."""
    from pysgmcmc_tpu.parallel.packed import sample_chain_stacked

    sampler = _gaussian_sampler()
    n = 16
    template = {"x": jnp.zeros(4), "y": jnp.zeros((2, 3))}
    positions = jax.tree_util.tree_map(
        lambda l: 0.1 * jax.random.normal(
            jax.random.PRNGKey(3), (n,) + l.shape), template)
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(4), n))
    states, _ = jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 1, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=100, collect_costs=False, phase="burn_in")
    )(states, jax.random.split(jax.random.PRNGKey(5), n))

    run = jax.jit(lambda s, k: sample_chain_stacked(
        sampler, s, k, 400, batch_fn=lambda kk: jnp.zeros(()),
        keep_every=5, bf16_params=bf16_params))
    states, positions, costs = run(states, jax.random.PRNGKey(6))
    draws = np.concatenate([
        np.asarray(l).reshape(-1)
        for l in jax.tree_util.tree_leaves(positions)
    ])
    assert np.isfinite(draws).all()
    assert abs(draws.mean()) < 0.1
    # bf16 gradients perturb each draw by O(2^-8) relative -- far below
    # the injected sampling noise; the tolerance covers both modes
    assert abs(draws.std() - 1.0) < 0.15
    assert costs.shape == (n, 400)
    assert int(states.step[0]) == 100 + 400 * 5


def test_lanes_pack_unpack_roundtrip():
    from pysgmcmc_tpu.parallel.packed import (
        make_lanes_spec, pack_lanes, unpack_lanes,
    )

    template = _template()
    spec = make_lanes_spec(template)
    assert all(off % 8 == 0 for off in spec.offsets)
    assert spec.rows % 256 == 0
    rng = np.random.RandomState(3)
    stacked = jax.tree_util.tree_map(
        lambda l: jnp.asarray(rng.standard_normal((4,) + l.shape),
                              jnp.float32), template)
    flat = pack_lanes(spec, stacked)
    assert flat.shape == (spec.rows, 4)
    out = unpack_lanes(spec, flat)
    for a, b in zip(jax.tree_util.tree_leaves(stacked),
                    jax.tree_util.tree_leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_lanes_chain_samples_gaussian(state_dtype):
    """The chains-on-lanes driver matches target moments.

    bf16 momentum/mass state perturbs each step by O(2^-8) relative on the
    momentum — far below the injected noise; the stationary moments must
    be indistinguishable at this tolerance.
    """
    from pysgmcmc_tpu.parallel.packed import sample_chain_lanes

    state_dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[state_dtype]
    sampler = _gaussian_sampler()
    n = 16
    template = {"x": jnp.zeros(4), "y": jnp.zeros((2, 3))}
    positions = jax.tree_util.tree_map(
        lambda l: 0.1 * jax.random.normal(
            jax.random.PRNGKey(3), (n,) + l.shape), template)
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(4), n))
    states, _ = jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 1, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=100, collect_costs=False, phase="burn_in")
    )(states, jax.random.split(jax.random.PRNGKey(5), n))

    run = jax.jit(lambda s, k: sample_chain_lanes(
        sampler, s, k, 400, batch_fn=lambda kk: jnp.zeros(()),
        keep_every=5, compute_dtype=None, state_dtype=state_dtype))
    states, positions, costs = run(states, jax.random.PRNGKey(6))
    draws = np.concatenate([
        np.asarray(l).reshape(-1)
        for l in jax.tree_util.tree_leaves(positions)
    ])
    assert np.isfinite(draws).all()
    assert abs(draws.mean()) < 0.1
    assert abs(draws.std() - 1.0) < 0.15
    assert costs.shape == (n, 400)
    assert int(states.step[0]) == 100 + 400 * 5


def test_packed_rejects_non_sghmc():
    from pysgmcmc_tpu.samplers.sgld import SGLDSampler

    sampler = SGLDSampler(lambda p: jnp.sum(p**2), stepsize_schedule=0.01)
    with pytest.raises(NotImplementedError):
        sample_chain_packed(sampler, None, jax.random.PRNGKey(0), 1)


@pytest.mark.slow
def test_lanes_sgld_samples_gaussian():
    """The lanes driver with SGLD matches target moments."""
    from pysgmcmc_tpu.parallel.packed import sample_chain_lanes
    from pysgmcmc_tpu.samplers.sgld import SGLDSampler

    sampler = SGLDSampler(
        lambda p, b: 0.5 * sum(jnp.sum(x**2) for x in
                               jax.tree_util.tree_leaves(p)),
        stepsize_schedule=0.05, burn_in_steps=100,
    )
    n = 16
    template = {"x": jnp.zeros(4), "y": jnp.zeros((2, 3))}
    positions = jax.tree_util.tree_map(
        lambda l: 0.1 * jax.random.normal(
            jax.random.PRNGKey(3), (n,) + l.shape), template)
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(4), n))
    states, _ = jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 1, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=100, collect_costs=False, phase="burn_in")
    )(states, jax.random.split(jax.random.PRNGKey(5), n))

    run = jax.jit(lambda s, k: sample_chain_lanes(
        sampler, s, k, 400, batch_fn=lambda kk: jnp.zeros(()),
        keep_every=5, compute_dtype=None))
    states, positions, costs = run(states, jax.random.PRNGKey(6))
    draws = np.concatenate([
        np.asarray(l).reshape(-1)
        for l in jax.tree_util.tree_leaves(positions)
    ])
    assert np.isfinite(draws).all()
    assert abs(draws.mean()) < 0.1
    assert abs(draws.std() - 1.0) < 0.15
    assert int(states.step[0]) == 100 + 400 * 5


@pytest.mark.slow
def test_lanes_psgld_samples_gaussian():
    """The lanes driver with pSGLD matches target moments."""
    from pysgmcmc_tpu.parallel.packed import sample_chain_lanes
    from pysgmcmc_tpu.samplers.psgld import PSGLDSampler

    sampler = PSGLDSampler(
        lambda p, b: 0.5 * sum(jnp.sum(x**2) for x in
                               jax.tree_util.tree_leaves(p)),
        stepsize_schedule=0.05,
    )
    n = 16
    template = {"x": jnp.zeros(4), "y": jnp.zeros((2, 3))}
    positions = jax.tree_util.tree_map(
        lambda l: 0.1 * jax.random.normal(
            jax.random.PRNGKey(3), (n,) + l.shape), template)
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(4), n))
    states, _ = jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 1, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=200, collect_costs=False)
    )(states, jax.random.split(jax.random.PRNGKey(5), n))

    run = jax.jit(lambda s, k: sample_chain_lanes(
        sampler, s, k, 400, batch_fn=lambda kk: jnp.zeros(()),
        keep_every=5, compute_dtype=None))
    states2, positions, costs = run(states, jax.random.PRNGKey(6))
    draws = np.concatenate([
        np.asarray(l).reshape(-1)
        for l in jax.tree_util.tree_leaves(positions)
    ])
    assert np.isfinite(draws).all()
    assert int(states2.step[0]) == 200 + 400 * 5

    # the lanes driver must match the PYTREE pSGLD's stationary moments
    # (pSGLD's preconditioned discretization over-disperses this target at
    # eps=0.05 -- that bias belongs to the sampler, not the driver)
    ref_run = jax.jit(jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 400, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=5)[1]))
    ref_positions = ref_run(
        states, jax.random.split(jax.random.PRNGKey(7), n))
    ref = np.concatenate([
        np.asarray(l).reshape(-1)
        for l in jax.tree_util.tree_leaves(ref_positions)
    ])
    assert abs(draws.mean() - ref.mean()) < 0.15
    assert abs(draws.std() - ref.std()) < 0.25 * ref.std()


@pytest.mark.slow
def test_lanes_rsghmc_samples_gaussian():
    """The lanes driver with relativistic SGHMC matches pytree moments."""
    from pysgmcmc_tpu.parallel.packed import sample_chain_lanes
    from pysgmcmc_tpu.samplers.relativistic_sghmc import (
        RelativisticSGHMCSampler,
    )

    sampler = RelativisticSGHMCSampler(
        lambda p, b: 0.5 * sum(jnp.sum(x**2) for x in
                               jax.tree_util.tree_leaves(p)),
        stepsize_schedule=0.05,
    )
    n = 16
    template = {"x": jnp.zeros(4), "y": jnp.zeros((2, 3))}
    positions = jax.tree_util.tree_map(
        lambda l: 0.1 * jax.random.normal(
            jax.random.PRNGKey(3), (n,) + l.shape), template)
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(4), n))
    states, _ = jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 1, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=200, collect_costs=False)
    )(states, jax.random.split(jax.random.PRNGKey(5), n))

    run = jax.jit(lambda s, k: sample_chain_lanes(
        sampler, s, k, 400, batch_fn=lambda kk: jnp.zeros(()),
        keep_every=5, compute_dtype=None))
    states2, positions_out, costs = run(states, jax.random.PRNGKey(6))
    draws = np.concatenate([
        np.asarray(l).reshape(-1)
        for l in jax.tree_util.tree_leaves(positions_out)
    ])
    assert np.isfinite(draws).all()

    ref_run = jax.jit(jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 400, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=5)[1]))
    ref_positions = ref_run(
        states, jax.random.split(jax.random.PRNGKey(7), n))
    ref = np.concatenate([
        np.asarray(l).reshape(-1)
        for l in jax.tree_util.tree_leaves(ref_positions)
    ])
    assert abs(draws.mean() - ref.mean()) < 0.15
    assert abs(draws.std() - ref.std()) < 0.25 * ref.std()
    assert int(states2.step[0]) == 200 + 400 * 5


def _lanes_parity_case(kind):
    """(sampler, phase) of one lanes-vs-pytree parity case."""
    from pysgmcmc_tpu.samplers.psgld import PSGLDSampler
    from pysgmcmc_tpu.samplers.relativistic_sghmc import (
        RelativisticSGHMCSampler,
    )
    from pysgmcmc_tpu.samplers.sgld import SGLDSampler
    from pysgmcmc_tpu.samplers.sgnht import SGNHTSampler

    def cost(p, b):
        return 0.5 * sum(jnp.sum(x**2) for x in jax.tree_util.tree_leaves(p))

    common = dict(gaussian_prior_scale=0.125)
    if kind.startswith("sghmc"):
        sampler = SGHMCSampler(cost, stepsize_schedule=0.05, burn_in_steps=3,
                               scale_grad=10.0, **common)
    elif kind.startswith("sgld"):
        sampler = SGLDSampler(cost, stepsize_schedule=0.01, burn_in_steps=3,
                              scale_grad=10.0, **common)
    elif kind == "psgld":
        sampler = PSGLDSampler(cost, stepsize_schedule=0.01, scale_grad=10.0,
                               **common)
    elif kind == "rsghmc":
        sampler = RelativisticSGHMCSampler(cost, stepsize_schedule=0.05,
                                           **common)
    else:
        sampler = SGNHTSampler(cost, stepsize_schedule=0.01, scale_grad=10.0,
                               **common)
    phase = "burn_in" if kind.endswith("burn_in") else "sampling"
    return sampler, phase


@pytest.mark.parametrize("kind", [
    "sghmc", "sgld", "psgld", "rsghmc", "sgnht",
    "sghmc_burn_in", "sgld_burn_in",
])
def test_lanes_update_matches_pytree_step_bitwise(kind):
    """The lanes drivers' update rules on the (rows, chains) layout ==
    the pytree sampler's step, given identical noise."""
    from pysgmcmc_tpu.parallel.packed import (
        adaptive_burnin_update,
        make_lanes_spec,
        pack_lanes,
        psgld_update,
        rsghmc_update,
        sgld_update,
        sgnht_update,
        unpack_lanes,
    )

    sampler, phase = _lanes_parity_case(kind)
    n = 5
    rng = np.random.RandomState(11)
    template = {"W": jnp.zeros((3, 4)), "b": jnp.zeros(4)}
    positions = jax.tree_util.tree_map(
        lambda l: jnp.asarray(rng.standard_normal((n,) + l.shape),
                              jnp.float32), template)
    states = jax.vmap(sampler.init)(
        positions, jax.random.split(jax.random.PRNGKey(0), n))
    n_pre = 1 if phase == "burn_in" else 3
    states, _ = jax.vmap(
        lambda s, k: sample_chain(
            sampler, s, k, 1, batch_fn=lambda kk: jnp.zeros(()),
            keep_every=n_pre, collect_costs=False)
    )(states, jax.random.split(jax.random.PRNGKey(1), n))
    eta = jax.vmap(normal_like_tree)(
        jax.random.split(jax.random.PRNGKey(2), n), states.position)
    ref, _ = jax.vmap(
        lambda s, e: sampler.step(
            s, jax.random.PRNGKey(0), jnp.zeros(()), noise=e, phase=phase)
    )(states, eta)

    spec = make_lanes_spec(template)

    def pk(tree):
        return pack_lanes(spec, tree)

    grads = jax.vmap(jax.grad(sampler.cost_fn))(
        states.position, jnp.zeros((n,)))
    eps = jnp.float32(sampler.stepsize_schedule.initial_value)
    args = (pk(states.position), pk(grads), eps, pk(eta))
    prior = sampler.gaussian_prior_scale
    got, want = {}, {"position": ref.position}
    if phase == "burn_in":
        stats = states.stats
        theta, v, tau, g, v_hat, minv = adaptive_burnin_update(
            args[0], pk(states.momentum) if kind.startswith("sghmc") else None,
            pk(stats.tau), pk(stats.g), pk(stats.v_hat), args[1], eps,
            args[3], sampler.scale_grad, prior,
            mdecay=getattr(sampler, "mdecay", None),
            a_coef=getattr(sampler, "A", None))
        got.update(position=theta, tau=tau, g=g, v_hat=v_hat, minv=minv)
        want.update(tau=ref.stats.tau, g=ref.stats.g, v_hat=ref.stats.v_hat,
                    minv=ref.stats.minv)
        if v is not None:
            got["momentum"], want["momentum"] = v, ref.momentum
    elif kind == "sghmc":
        got["position"], got["momentum"] = sghmc_update(
            args[0], pk(states.momentum), args[1], pk(states.stats.minv),
            eps, args[3], sampler.mdecay, sampler.scale_grad, prior)
        want["momentum"] = ref.momentum
    elif kind == "sgld":
        got["position"] = sgld_update(
            args[0], args[1], pk(states.stats.minv), eps, args[3],
            sampler.A, sampler.scale_grad, prior)
    elif kind == "psgld":
        got["position"], got["v"] = psgld_update(
            args[0], pk(states.v), args[1], eps, args[3], sampler.alpha,
            sampler.lambda_reg, sampler.scale_grad, prior)
        want["v"] = ref.v
    elif kind == "rsghmc":
        got["position"], got["momentum"] = rsghmc_update(
            args[0], pk(states.momentum), args[1], eps, args[3], sampler.D,
            sampler.Bhat, sampler.mass, sampler.speed_of_light, prior)
        want["momentum"] = ref.momentum
    else:
        xi = states.xi.reshape(1, n)
        got["position"], got["momentum"] = sgnht_update(
            args[0], pk(states.momentum), args[1], xi, eps, args[3],
            sampler.a_diff, sampler.scale_grad, prior)
        want["momentum"] = ref.momentum
    for name, value in got.items():
        for a, b in zip(jax.tree_util.tree_leaves(want[name]),
                        jax.tree_util.tree_leaves(unpack_lanes(spec, value))):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=name)
