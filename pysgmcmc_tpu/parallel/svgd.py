"""Mesh-sharded SVGD: the ensemble axis split across devices.

Unlike MCMC chains (embarrassingly parallel), SVGD particles *interact*
every step through the kernel matrix, so sharding the ensemble requires
real collectives: each device holds a particle shard, ``all_gather``s the
flattened ensemble (and its gradients), computes its local rows of
the RBF kernel against the global ensemble, and updates its shard.  The
median-heuristic bandwidth is computed from the full distance matrix
(gathered rows), so the sharded step is numerically identical to the
single-device step (asserted in tests).

This is the answer to the reference's scalability ceiling: the
O(n^2) Python-loop ``pdist`` (``/root/reference/pysgmcmc/tensor_utils.py:
405-409``) capped ensembles at a few dozen particles; here the quadratic
work is matmuls distributed over the mesh.

Examples
--------
>>> import jax, jax.numpy as jnp
>>> from pysgmcmc_tpu.parallel.mesh import chain_mesh
>>> from pysgmcmc_tpu.samplers.svgd import SVGDSampler
>>> sampler = SVGDSampler(lambda x: 0.5 * jnp.sum(x**2))
>>> state = sampler.init(jax.random.normal(jax.random.PRNGKey(0), (8, 2)))
>>> state, costs = run_svgd_sharded(
...     sampler, state, jax.random.PRNGKey(1), 2, chain_mesh(2))
>>> state.position.shape
(8, 2)
"""

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from pysgmcmc_tpu.parallel.mesh import CHAIN_AXIS, chain_sharding, shard_chains
from pysgmcmc_tpu.samplers.svgd import SVGDState, _ravel_particles
from pysgmcmc_tpu.utils.numeric import median


def _sharded_step_fn(sampler, unravel_one, batch_is_none, axis_name):
    """Build the per-shard step: local particles against the gathered ensemble."""

    def step_shard(flat_local, hist_local, sched_state, step, key, batch):
        def flat_cost(row, batch):
            params = unravel_one(row)
            if batch_is_none:
                return sampler.cost_fn(params)
            return sampler.cost_fn(params, batch)

        if batch_is_none:
            costs_local, grads_local = jax.vmap(
                jax.value_and_grad(lambda row: flat_cost(row, None))
            )(flat_local)
        else:
            costs_local, grads_local = jax.vmap(
                jax.value_and_grad(flat_cost), in_axes=(0, None)
            )(flat_local, batch)

        flat_global = jax.lax.all_gather(flat_local, axis_name, tiled=True)
        grads_global = jax.lax.all_gather(grads_local, axis_name, tiled=True)
        n = flat_global.shape[0]

        # local kernel rows against the global ensemble
        local_norms = jnp.sum(flat_local * flat_local, axis=1)
        global_norms = jnp.sum(flat_global * flat_global, axis=1)
        gram = jnp.dot(
            flat_local, flat_global.T, preferred_element_type=flat_local.dtype
        )
        d2_local = jnp.maximum(
            local_norms[:, None] + global_norms[None, :] - 2.0 * gram, 0.0
        )
        # bandwidth from the FULL matrix (bitwise parity with the
        # single-device path requires the same median input)
        d2_full = jax.lax.all_gather(d2_local, axis_name, tiled=True)
        h = jnp.sqrt(
            0.5 * median(d2_full) / jnp.log(jnp.asarray(n, d2_full.dtype) + 1.0)
        )

        kernel = jnp.exp(-d2_local / (2.0 * h**2))
        kernel_sum = jnp.sum(kernel, axis=1)
        grad_kernel = (
            flat_local * kernel_sum[:, None]
            - jnp.dot(kernel, flat_global,
                      preferred_element_type=flat_local.dtype)
        ) / h**2
        phi = (
            jnp.dot(kernel, -grads_global,
                    preferred_element_type=flat_local.dtype)
            + grad_kernel
        ) / n

        eps = jnp.asarray(
            sampler.stepsize_schedule.value(sched_state, step),
            flat_local.dtype,
        )
        hist_new = sampler.alpha * hist_local + (1.0 - sampler.alpha) * phi**2
        adjusted = phi / (sampler.fudge_factor + jnp.sqrt(hist_new))
        return flat_local + eps * adjusted, hist_new, costs_local

    return step_shard


def run_svgd_sharded(sampler, state, key, n_steps, mesh,
                     batch_fn=None, axis_name=CHAIN_AXIS):
    """Run ``n_steps`` SVGD updates with the particle axis sharded on ``mesh``.

    ``state`` is an :class:`~pysgmcmc_tpu.samplers.svgd.SVGDState` (as from
    ``sampler.init``); returns the final state (particle axis sharded) and
    the per-particle costs of the final step.  Minibatches are shared
    across particles each step (the ensemble jointly approximates one
    posterior).
    """
    flat, unravel = _ravel_particles(state.position)
    hist_flat, _ = _ravel_particles(state.historical_grad)
    n = flat.shape[0]
    n_devices = mesh.devices.size
    if n % n_devices != 0:
        raise ValueError(
            "run_svgd_sharded: n_particles ({}) must be divisible by the "
            "mesh size ({})".format(n, n_devices)
        )

    # row-unraveler from a single-particle template
    from jax.flatten_util import ravel_pytree

    template = jax.tree_util.tree_map(lambda leaf: leaf[0], state.position)
    _, unravel_one = ravel_pytree(template)

    step_shard = _sharded_step_fn(
        sampler, unravel_one, batch_fn is None, axis_name
    )
    spec = PartitionSpec(axis_name)
    replicated = PartitionSpec()

    def scan_body(carry, _):
        flat, hist, sched_state, step, key = carry
        key, key_batch = jax.random.split(key)
        batch = batch_fn(key_batch) if batch_fn is not None else None
        sharded = jax.shard_map(
            step_shard,
            mesh=mesh,
            in_specs=(spec, spec, replicated, replicated, replicated,
                      replicated),
            out_specs=(spec, spec, spec),
        )
        flat, hist, costs = sharded(flat, hist, sched_state, step, key, batch)
        sched_state = sampler.stepsize_schedule.update(sched_state, cost=costs)
        return (flat, hist, sched_state, step + 1, key), costs

    flat = shard_chains(flat, mesh, axis_name)
    hist_flat = jax.device_put(hist_flat, chain_sharding(mesh, axis_name))

    @jax.jit
    def run(flat, hist, sched_state, step, key):
        (flat, hist, sched_state, step, _), costs = jax.lax.scan(
            scan_body, (flat, hist, sched_state, step, key), None,
            length=n_steps,
        )
        return flat, hist, sched_state, step, costs[-1]

    flat, hist, sched_state, step, last_costs = run(
        flat, hist_flat, state.schedule_state, state.step, key
    )
    new_state = SVGDState(
        position=unravel(flat),
        historical_grad=unravel(hist),
        step=step,
        schedule_state=sched_state,
    )
    return new_state, last_costs
