"""Smoke tests for the driver-facing artifacts.

bench.py measures only on a GPU; these tests exercise its workload builder
and programs at tiny sizes on CPU so API drift cannot silently break the
benchmark (or the graft entry points).
"""

import os
import sys

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.slow


# repo root (for `import bench`) relative to THIS file, so the
# mutation harness's copied trees test their own package, not
# the original checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_bench_workload_tiny_run():
    from bench import build_workload
    from pysgmcmc_tpu.parallel.chains import run_chains

    sampler, positions, select_batch = build_workload(n_chains=4)
    chains, costs = run_chains(
        sampler, positions, jax.random.PRNGKey(0), 1,
        batch_fn=select_batch, keep_every=3,
    )
    assert costs.shape == (4, 1)
    assert np.isfinite(np.asarray(costs)).all()


def test_bench_workload_bf16_variant():
    import jax.numpy as jnp

    from bench import build_workload
    from pysgmcmc_tpu.parallel.chains import run_chains

    sampler, positions, select_batch = build_workload(
        n_chains=2, compute_dtype=jnp.bfloat16
    )
    chains, costs = run_chains(
        sampler, positions, jax.random.PRNGKey(1), 1,
        batch_fn=select_batch, keep_every=2,
    )
    assert np.isfinite(np.asarray(costs)).all()


def test_bench_workload_prior_fold_matches_autodiff():
    """gaussian_prior_scale fold == differentiating the prior inside cost_fn.

    Same seed, same noise keys: positions must agree to float32 tolerance
    after several steps crossing nothing but op order.
    """
    from bench import build_workload
    from pysgmcmc_tpu.samplers.base import sample_chain

    folded, positions, select_batch = build_workload(
        n_chains=2, fold_weight_prior=True)
    explicit, _, _ = build_workload(n_chains=2, fold_weight_prior=False)

    def run(sampler):
        state = jax.vmap(sampler.init)(
            positions, jax.random.split(jax.random.PRNGKey(0), 2))
        runner = jax.vmap(
            lambda st, k: sample_chain(
                sampler, st, k, 1, batch_fn=select_batch, keep_every=10)[1]
        )
        return runner(state, jax.random.split(jax.random.PRNGKey(1), 2))

    pos_fold = run(folded)
    pos_expl = run(explicit)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-7),
        pos_fold, pos_expl,
    )


def test_graft_entry_single_chip():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (64, 2)


def test_graft_dryrun_multichip():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_bench_dense_lanes_path_tiny():
    """The dense workload through the lanes driver, bf16 state, end to
    end."""
    import jax.numpy as jnp

    from bench import build_workload
    from pysgmcmc_tpu.parallel.packed import sample_chain_lanes
    from pysgmcmc_tpu.samplers.base import sample_chain

    sampler, positions, select_batch = build_workload(
        n_chains=4, network="dense")

    def one(position, ck):
        k_init, k_burn = jax.random.split(ck)
        state = sampler.init(position, k_init)
        state, _ = sample_chain(
            sampler, state, k_burn, 1, batch_fn=select_batch,
            keep_every=3, collect_costs=False, phase="burn_in")
        return state

    states = jax.vmap(one)(
        positions, jax.random.split(jax.random.PRNGKey(0), 4))
    states, _, costs = jax.jit(
        lambda s, k: sample_chain_lanes(
            sampler, s, k, 1, batch_fn=select_batch, keep_every=2,
            state_dtype=jnp.bfloat16, collect_positions=False)
    )(states, jax.random.PRNGKey(1))
    assert costs.shape == (4, 1)
    assert np.isfinite(np.asarray(costs)).all()


def test_bench_chain_programs_tiny():
    """The timed flagship programs (burn-in, then one sampling segment)."""
    from bench import build_workload, chain_programs

    sampler, positions, select_batch = build_workload(
        n_chains=4, burn_in_steps=3)
    init_and_burn, sampling = chain_programs(
        sampler, select_batch, burn_in_steps=3, scan_steps=2)
    states = jax.jit(jax.vmap(init_and_burn))(
        positions, jax.random.split(jax.random.PRNGKey(0), 4))
    states, costs = jax.jit(jax.vmap(sampling))(
        states, jax.random.split(jax.random.PRNGKey(1), 4))
    assert costs.shape == (4,)
    assert np.isfinite(np.asarray(costs)).all()
    assert int(states.step[0]) == 3 + 2
