"""Massively parallel chains: vmap over a sharded chain axis.

This module is the on-device replacement for the reference's sequential
multi-chain extraction (``/root/reference/pysgmcmc/diagnostics/
sample_chains.py:338-384``, one fresh graph + session per chain): all chains
advance in lockstep inside a single jitted ``vmap(scan)`` program, and the
chain axis shards across a :func:`pysgmcmc_tpu.parallel.mesh.chain_mesh` so
8k+ chains spread over a pod slice with zero cross-chain communication in
the hot loop.

Examples
--------
>>> import jax, jax.numpy as jnp
>>> from pysgmcmc_tpu.samplers.sgld import SGLDSampler
>>> sampler = SGLDSampler(lambda x: 0.5 * jnp.sum(x**2),
...                       stepsize_schedule=0.05, burn_in_steps=0)
>>> positions = stack_positions(jnp.zeros(2), 4)
>>> chains, costs = run_chains(sampler, positions, jax.random.PRNGKey(0), 3)
>>> (chains.shape, costs.shape)
((4, 3, 2), (4, 3))
"""

import weakref

import jax
import jax.numpy as jnp

from pysgmcmc_tpu.parallel.mesh import (
    CHAIN_AXIS,
    chain_sharding,
    mesh_chain_axes,
    shard_chains,
)
from pysgmcmc_tpu.samplers.base import sample_chain


def _n_chains(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    if not leaves:
        raise ValueError("run_chains: empty initial_positions pytree")
    return leaves[0].shape[0]


def stack_positions(position, n_chains, jitter=0.0, key=None):
    """Broadcast one initial position to ``n_chains`` chains.

    With ``jitter > 0`` each chain starts at ``position + jitter * N(0, 1)``
    (overdispersed initialization, which Gelman-Rubin diagnostics assume).
    """
    stacked = jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(
            jnp.asarray(leaf)[None], (n_chains,) + jnp.shape(leaf)
        ),
        position,
    )
    if jitter:
        if key is None:
            raise ValueError("stack_positions: jitter requires a PRNG key")
        leaves, treedef = jax.tree_util.tree_flatten(stacked)
        keys = jax.random.split(key, len(leaves))
        leaves = [
            leaf + jitter * jax.random.normal(k, leaf.shape, leaf.dtype)
            for k, leaf in zip(keys, leaves)
        ]
        stacked = jax.tree_util.tree_unflatten(treedef, leaves)
    return stacked


# jit programs are cached on callable identity, so building a fresh
# vmap closure per call would recompile every time.  Cache runners keyed
# on the static configuration instead.
#
# Keys hold *weak* references to the sampler / batch_fn / mesh: ``id()``
# keys would be unsafe (a garbage-collected object's id can be reused by a
# new object, silently returning a runner closed over stale
# hyperparameters), and strong references would leak every sampler ever
# run.  A dead entry is evicted by the weakref callback; a new object at
# the same address gets a distinct ``weakref.ref`` and therefore a fresh
# runner.
_RUNNER_CACHE = {}


def _cache_ref(obj, evict):
    """A hashable identity token for ``obj`` that dies with it."""
    if obj is None:
        return None
    try:
        return weakref.ref(obj, evict)
    except TypeError:
        # Not weakref-able (e.g. builtins): hold it strongly.  Identity
        # stays valid for the lifetime of the cache entry, so no id reuse.
        return obj


def make_chain_runner(
    sampler,
    n_samples,
    batch_fn=None,
    keep_every=1,
    mesh=None,
    axis_name=CHAIN_AXIS,
    phase=None,
):
    """Build (and cache) the jitted multi-chain runner.

    Returns ``runner(initial_positions, chain_keys) -> (positions, costs)``.
    Reusing the same ``sampler``/``batch_fn`` objects across calls hits the
    compile cache.
    """
    axis_name = mesh_chain_axes(mesh, axis_name)
    key_box = []

    # bind the cache as a default arg: at interpreter shutdown module
    # globals are cleared to None before pending weakref callbacks run
    def evict(_ref, _box=key_box, _cache=_RUNNER_CACHE):
        if _box and _cache is not None:
            _cache.pop(_box[0], None)

    cache_key = (
        _cache_ref(sampler, evict), n_samples, _cache_ref(batch_fn, evict),
        keep_every, _cache_ref(mesh, evict), axis_name, phase,
    )
    key_box.append(cache_key)
    if cache_key in _RUNNER_CACHE:
        return _RUNNER_CACHE[cache_key]

    def one_chain(position, chain_key):
        key_init, key_run = jax.random.split(chain_key)
        state = sampler.init(position, key_init)
        _, positions, costs = sample_chain(
            sampler,
            state,
            key_run,
            n_samples,
            batch_fn=batch_fn,
            keep_every=keep_every,
            phase=phase,
        )
        return positions, costs

    vmapped = jax.vmap(one_chain)

    if mesh is None:
        runner = jax.jit(vmapped)
    else:
        # shard_map over the chain axis: every device runs the identical
        # vmapped scan on its local slice of chains — pure SPMD, zero
        # collectives in the hot loop.  (A plain jit + NamedSharding would
        # also work in principle, but jax's partitionable-threefry lowering
        # rejects sharded key arrays without a surrounding mesh context; the
        # shard_map formulation sidesteps that and is bitwise identical to
        # the unsharded vmap.)
        from jax.sharding import PartitionSpec

        spec = PartitionSpec(axis_name)
        runner = jax.jit(
            jax.shard_map(vmapped, mesh=mesh, in_specs=spec, out_specs=spec)
        )

    _RUNNER_CACHE[cache_key] = runner
    return runner


def run_chains(
    sampler,
    initial_positions,
    key,
    n_samples,
    batch_fn=None,
    keep_every=1,
    mesh=None,
    axis_name=CHAIN_AXIS,
    phase=None,
):
    """Run one chain per leading-axis slice of ``initial_positions``.

    Returns ``(positions, costs)`` with shapes
    ``(n_chains, n_samples, *param_shape)`` and ``(n_chains, n_samples)``.

    Parameters
    ----------
    mesh : jax.sharding.Mesh, optional
        If given, the chain axis of inputs and outputs is sharded over the
        mesh; the per-chain scan runs SPMD on every device with no
        collectives (chains are independent).
    phase : str, optional
        Static burn-in/sampling specialization forwarded to
        :func:`pysgmcmc_tpu.samplers.base.sample_chain`.
    """
    n_chains = _n_chains(initial_positions)
    chain_keys = jax.random.split(key, n_chains)
    axis_name = mesh_chain_axes(mesh, axis_name)

    if mesh is not None:
        n_mesh = mesh.devices.size
        if n_chains % n_mesh != 0:
            raise ValueError(
                "run_chains: n_chains ({}) must be divisible by the mesh "
                "size ({})".format(n_chains, n_mesh)
            )
        initial_positions = shard_chains(initial_positions, mesh, axis_name)
        chain_keys = jax.device_put(
            chain_keys, chain_sharding(mesh, axis_name)
        )

    runner = make_chain_runner(
        sampler, n_samples, batch_fn, keep_every, mesh, axis_name, phase
    )
    return runner(initial_positions, chain_keys)
