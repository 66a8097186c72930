"""Headline benchmark: vmapped SGHMC chains on the 3-layer BNN, on a GPU.

Workload (BASELINE.md north star): 8192 independent SGHMC chains, each
sampling the posterior of the reference's 3x50-tanh heteroscedastic BNN on
sinc data (100 points, batch 20), advancing in lockstep inside one jitted
``vmap(scan)`` program on one device.  The chains first run their full
3000-step self-tuning burn-in, then the *steady-state sampling phase* is
timed — the phase that dominates real workloads (the reference default is
50k sampling iterations after 1-3k burn-in,
``/root/reference/pysgmcmc/models/bayesian_neural_network.py:148-156``)
and the one the static phase-split specializes (frozen mass matrix, no
adaptation-statistics traffic; see ``samplers/_adaptive.py``).

Metric: sampler update-steps per second (chains x scan-steps / wall time)
on the XLA path (``samplers.base.sample_chain`` under ``jax.vmap``).

Run ``python bench.py`` on a machine with a GPU.  It fails without one.
It prints the card's name and power limit and the JAX device on earlier
lines, and exactly one JSON result line last.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from pysgmcmc_tpu.data_batches import batch_fn as make_batch_fn
from pysgmcmc_tpu.diagnostics.objective_functions import sinc
from pysgmcmc_tpu.models.architectures import default_network
from pysgmcmc_tpu.models.bayesian_neural_network import (
    log_variance_prior_log_like,
    weight_prior_log_like,
)
from pysgmcmc_tpu.samplers.base import sample_chain
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler

REPO = os.path.dirname(os.path.abspath(__file__))
N_CHAINS = 8192
BURN_IN_STEPS = 3000
SCAN_STEPS = 200


def build_workload(
    n_chains, dtype=jnp.float32, compute_dtype=None,
    n_data=100, batch_size=20, fold_weight_prior=True, noise_bits=None,
    network="default", return_data=False, units=(50, 50, 50),
    burn_in_steps=BURN_IN_STEPS,
):
    """The north-star posterior: 3x50 heteroscedastic BNN on sinc data.

    - ``compute_dtype``: ``None`` runs the network in ``dtype``;
      ``jnp.bfloat16`` runs its matmuls in bf16.
    - ``fold_weight_prior=True``: the L2 weight prior's gradient is folded
      analytically into the sampler update (``gaussian_prior_scale``) —
      identical dynamics, one autodiff term less.  The reported per-step
      cost omits the (tiny, slowly-varying) weight-prior term.
    """
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.uniform(0.0, 1.0, (n_data, 1)), dtype)
    y = jnp.asarray(np.asarray(sinc(np.asarray(x))), dtype)

    if network == "dense":
        # the same architecture with squeezed parameter shapes (identical
        # math and init draws; see models/architectures.py)
        from pysgmcmc_tpu.models.architectures import dense_network

        init_fn, apply_fn = dense_network(1, units=units, dtype=dtype)
    else:
        init_fn, apply_fn = default_network(1, units=units, dtype=dtype)
    params0 = init_fn(jax.random.PRNGKey(0))
    n_params = sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(params0)
    )

    def cost_fn(params, batch):
        xb, yb = batch
        if compute_dtype is not None:
            params_c = jax.tree_util.tree_map(
                lambda leaf: leaf.astype(compute_dtype), params
            )
            out = apply_fn(params_c, xb.astype(compute_dtype)).astype(dtype)
        else:
            out = apply_fn(params, xb)
        f_mean, f_log_var = out[:, 0:1], out[:, 1:2]
        f_var_inv = 1.0 / (jnp.exp(f_log_var) + 1e-16)
        mse = jnp.square(yb - f_mean)
        ll = jnp.sum(jnp.sum(-mse * 0.5 * f_var_inv - 0.5 * f_log_var, axis=1))
        ll = ll / batch_size
        ll += log_variance_prior_log_like(f_log_var) / n_data
        if not fold_weight_prior:
            ll += weight_prior_log_like(params) / n_data
        return -ll

    # cost = -ll; the omitted prior term is wdecay/2 ||theta||^2 / (P N),
    # so its cost gradient is theta * wdecay / (P N) with wdecay = 1.
    prior_scale = 1.0 / (n_params * n_data) if fold_weight_prior else 0.0

    sampler = SGHMCSampler(
        cost_fn,
        stepsize_schedule=float(np.sqrt(1e-4)),
        burn_in_steps=burn_in_steps,
        scale_grad=float(n_data),
        dtype=dtype,
        gaussian_prior_scale=prior_scale,
        noise_bits=noise_bits,
    )
    select_batch = make_batch_fn(x, y, batch_size)
    # stacked positions built host-side in one pass
    host_rng = np.random.RandomState(1)
    positions = jax.tree_util.tree_map(
        lambda leaf: jnp.asarray(
            np.asarray(leaf)[None]
            + 0.01 * host_rng.standard_normal((n_chains,) + leaf.shape),
            dtype,
        ),
        params0,
    )
    if return_data:
        return sampler, positions, select_batch, (x, y)
    return sampler, positions, select_batch


def chain_programs(sampler, select_batch, burn_in_steps=BURN_IN_STEPS,
                   scan_steps=SCAN_STEPS):
    """The per-chain programs of the flagship job.

    ``init_and_burn(position, chain_key) -> state`` runs init and the whole
    self-tuning burn-in; ``sampling(state, key) -> (state, cost)`` runs one
    ``scan_steps`` sampling segment and returns its last minibatch cost.
    ``jax.vmap`` maps them over chains.
    """

    def init_and_burn(position, chain_key):
        k_init, k_burn = jax.random.split(chain_key)
        state = sampler.init(position, k_init)
        state, _ = sample_chain(
            sampler, state, k_burn, 1,
            batch_fn=select_batch,
            keep_every=burn_in_steps,
            collect_costs=False,
            phase="burn_in",
        )
        return state

    def sampling(state, key):
        state, _, costs = sample_chain(
            sampler, state, key, 1,
            batch_fn=select_batch,
            keep_every=scan_steps,
            phase="sampling",
        )
        return state, costs[-1]

    return init_and_burn, sampling


def main():
    from pysgmcmc_tpu.utils.device import (
        device_record,
        enable_compile_cache,
        nvidia_smi_name_and_power_limit,
        require_gpu,
    )

    devices = require_gpu()
    enable_compile_cache(os.path.join(REPO, ".jax_cache"))
    print("card:", nvidia_smi_name_and_power_limit())
    print("device:", json.dumps(device_record(devices)))

    repeats = 5
    sampler, positions, select_batch = build_workload(N_CHAINS)
    init_and_burn, sampling = chain_programs(sampler, select_batch)
    burn = jax.jit(jax.vmap(init_and_burn))
    sample = jax.jit(jax.vmap(sampling))

    def keys(i):
        return jax.random.split(jax.random.PRNGKey(i), N_CHAINS)

    # Full self-tuning burn-in (one compiled scan), then time steady state.
    states = burn(positions, keys(2))
    jax.block_until_ready(states)

    # Warmup / compile of the sampling-phase program.
    states, costs = sample(states, keys(3))
    jax.block_until_ready(states)

    elapsed = []
    for i in range(repeats):
        t0 = time.perf_counter()
        states, costs = sample(states, keys(4 + i))
        jax.block_until_ready(states)
        elapsed.append(time.perf_counter() - t0)

    if not np.isfinite(np.asarray(costs)).all():
        raise RuntimeError("non-finite costs")
    median = float(np.median(elapsed))
    print(json.dumps({
        "metric": "SGHMC sampling-phase update-steps/sec (8192-chain 3x50 "
                  "BNN on sinc, f32, vmap(sample_chain) XLA path, after the "
                  "full 3000-step burn-in; median of {} segments of {} "
                  "steps)".format(repeats, SCAN_STEPS),
        "value": N_CHAINS * SCAN_STEPS / median,
        "unit": "steps/sec",
        "ms_per_step": 1e3 * median / SCAN_STEPS,
        "device": device_record(devices),
    }))


if __name__ == "__main__":
    main()
