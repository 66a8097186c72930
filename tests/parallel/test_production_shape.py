"""The bench.py program, end to end, on the virtual 8-device mesh.

The flagship job — full (short) self-tuning burn-in, then SGHMC sampling
on the XLA path — run over the 8-virtual-device chain mesh with
:func:`pysgmcmc_tpu.parallel.chains.run_chains`, with the collected
posterior pooled ACROSS shards into the multi-chain diagnostics.

Assertions:
  * the pooled cross-shard function-space ESS and PSRF are finite,
  * the collected posterior is invariant to the shard count — the 8-device,
    4-device and unsharded runs of the identical program produce bitwise
    identical chains (any difference would be a decomposition bug in the
    sharded runner: key placement, chain order, or layout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.diagnostics.sampler_diagnostics import (
    effective_sample_size,
    gelman_rubin,
)
from pysgmcmc_tpu.parallel.chains import run_chains
from pysgmcmc_tpu.parallel.mesh import chain_mesh

pytestmark = pytest.mark.slow


N_CHAINS = 16
BURN_IN = 12
N_SAMPLES = 6
KEEP_EVERY = 4


def _run(mesh):
    # tests/conftest inserts the repo root on sys.path
    from bench import build_workload

    sampler, positions, select_batch = build_workload(
        N_CHAINS, burn_in_steps=BURN_IN)
    chains, costs = run_chains(
        sampler, positions, jax.random.PRNGKey(2), N_SAMPLES + BURN_IN
        // KEEP_EVERY, batch_fn=select_batch, keep_every=KEEP_EVERY,
        mesh=mesh)
    burn = BURN_IN // KEEP_EVERY
    chains = jax.tree_util.tree_map(lambda leaf: leaf[:, burn:], chains)
    return chains, costs[:, burn:]


def test_bench_program_on_8_device_mesh_pooled_diagnostics():
    chains, costs = _run(chain_mesh(8))

    assert costs.shape == (N_CHAINS, N_SAMPLES)
    assert np.isfinite(np.asarray(costs)).all()

    # Pool the shards into function-space multi-chain diagnostics.
    from pysgmcmc_tpu.models.architectures import default_network

    _, apply_fn = default_network(1)
    probes = jnp.linspace(0.0, 1.0, 8).reshape(8, 1)
    f_vals = jax.vmap(jax.vmap(lambda p: apply_fn(p, probes)[:, 0]))(chains)
    assert f_vals.shape == (N_CHAINS, N_SAMPLES, 8)
    assert np.isfinite(np.asarray(f_vals)).all()

    ess = np.asarray(effective_sample_size(f_vals))
    psrf = np.asarray(gelman_rubin(f_vals))
    assert ess.shape == (8,) and psrf.shape == (8,)
    assert np.isfinite(ess).all() and (ess > 0).all()
    # m*n pooled ESS can't exceed the pooled draw count
    assert (ess <= N_CHAINS * N_SAMPLES + 1e-3).all()
    assert np.isfinite(psrf).all() and (psrf > 0).all()


def test_bench_program_shard_count_invariant():
    """8-device == 4-device == unsharded, bitwise, chain for chain."""
    runs = {n: _run(chain_mesh(n) if n else None) for n in (8, 4, 0)}
    chains8, costs8 = runs[8]
    for n in (4, 0):
        chains_n, costs_n = runs[n]
        np.testing.assert_array_equal(
            np.asarray(costs8), np.asarray(costs_n),
            err_msg="costs, {} vs 8 devices".format(n or "unsharded"))
        for key in chains8:
            np.testing.assert_array_equal(
                np.asarray(chains8[key]), np.asarray(chains_n[key]),
                err_msg="positions[{}], {} vs 8 devices".format(
                    key, n or "unsharded"))
