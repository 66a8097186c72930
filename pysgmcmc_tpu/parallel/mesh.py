"""Device mesh helpers for chain-parallel SG-MCMC.

The reference has no distributed support at all — its "multi-chain" runner
executes chains sequentially in fresh TF graphs
(``/root/reference/pysgmcmc/diagnostics/sample_chains.py:369-382``).  Chain
parallelism over a device mesh is therefore a new first-class component
here: chains are embarrassingly parallel, so the natural layout is a 1-D mesh
with the chain axis sharded across devices; pooled diagnostics
(between-chain variance in Gelman-Rubin, pooled ESS) become XLA collectives
that GSPMD inserts automatically from the array shardings.

Examples
--------
>>> mesh = chain_mesh(2)
>>> mesh.devices.shape
(2,)
>>> chain_sharding(mesh).spec
PartitionSpec('chains',)
"""

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

CHAIN_AXIS = "chains"


def chain_mesh(n_devices=None, axis_name=CHAIN_AXIS):
    """A 1-D mesh over the first ``n_devices`` devices for the chain axis."""
    devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(
            "chain_mesh: requested {} devices but only {} available".format(
                n, len(devices)
            )
        )
    return jax.make_mesh((n,), (axis_name,), devices=devices[:n])


def chain_sharding(mesh, axis_name=CHAIN_AXIS):
    """NamedSharding that splits the leading (chain) axis across the mesh.

    ``axis_name`` may be a tuple of mesh axis names (e.g.
    ``("hosts", "chains")`` for a :func:`multihost_mesh`), in which case the
    leading array axis shards over all of them — chains spread over every
    device of the 2-D mesh.
    """
    return NamedSharding(mesh, PartitionSpec(axis_name))


HOST_AXIS = "hosts"

_DISTRIBUTED_INITIALIZED = False


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, **kwargs):
    """Initialize the JAX distributed runtime for a multi-host run.

    Call once per host process *before* any other JAX call, then build the
    mesh with :func:`multihost_mesh`.  With no arguments, the cluster is
    read from the ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` environment variables; without them this is a
    single-process run and the call does nothing.  Idempotent: a second call (or a call in an
    already-initialized or single-process context) is a no-op.

    This is a new capability axis over the reference, which is strictly
    single-process (one TF session per chain,
    ``/root/reference/pysgmcmc/diagnostics/sample_chains.py:369-382``).
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return
    # Already-initialized test WITHOUT touching the backend:
    # jax.process_count() would initialize XLA, after which
    # jax.distributed.initialize() hard-fails ("must be called before the
    # backend is initialized") — turning a real multi-host run into N
    # silently-independent single-host processes.  The distributed
    # client handle is the backend-free signal.
    try:
        from jax._src import distributed as _jax_distributed

        if _jax_distributed.global_state.client is not None:
            _DISTRIBUTED_INITIALIZED = True
            return
    except (ImportError, AttributeError):
        pass  # private-API drift: fall through to initialize()
    explicit = not (
        coordinator_address is None and num_processes is None
        and process_id is None and not kwargs
    )
    if not explicit:
        import os

        # Only attempt auto-detection when the environment advertises a
        # cluster: jax.distributed.initialize() can block waiting for a
        # coordinator that does not exist.
        cluster = any(os.environ.get(v) for v in (
            "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
            "JAX_NUM_PROCESSES",
        ))
        if not cluster:
            return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
        _DISTRIBUTED_INITIALIZED = True
    except (RuntimeError, ValueError) as err:
        if "already" in str(err).lower():  # initialized elsewhere — fine
            _DISTRIBUTED_INITIALIZED = True
        elif explicit:
            # Includes "must be called before the backend is initialized":
            # swallowing it would let a cluster run proceed as N independent
            # single-host processes.
            raise
        else:
            # Auto-detection is best effort, but never silent: a real
            # cluster operator must see that this process is about to run
            # standalone.
            import logging

            logging.warning(
                "initialize_multihost: cluster environment detected but "
                "jax.distributed.initialize() failed (%s); proceeding as "
                "a single-process run. Call initialize_multihost() before "
                "any other JAX API to join the cluster.", err,
            )


def multihost_mesh(n_hosts=None, host_axis=HOST_AXIS, chain_axis=CHAIN_AXIS):
    """A 2-D ``(hosts, chips)`` mesh for multi-host chain parallelism.

    The outer ``host_axis`` groups each host's local devices together, so
    any collective that partitions over it rides the slower cross-host
    network while everything inside a host stays on the host's own
    device interconnect.  Chains are
    independent — shard their leading axis over *both* axes
    (``PartitionSpec((host_axis, chain_axis))``, see
    :func:`chain_sharding`) and the hot loop stays collective-free; only
    pooled diagnostics (R-hat between-chain variance, pooled ESS) ever cross
    hosts, and those run once per analysis, not per step.

    ``n_hosts`` defaults to ``jax.process_count()`` (the real topology in a
    :func:`initialize_multihost` run).  Passing it explicitly lets a
    single-process test emulate the host grouping on a virtual device mesh
    (``--xla_force_host_platform_device_count``).

    Examples
    --------
    >>> mesh = multihost_mesh(n_hosts=2)  # doctest: +SKIP
    >>> mesh.axis_names  # doctest: +SKIP
    ('hosts', 'chains')
    """
    devices = jax.devices()
    if n_hosts is None:
        n_hosts = jax.process_count()
    if n_hosts <= 0 or len(devices) % n_hosts != 0:
        raise ValueError(
            "multihost_mesh: {} devices do not split evenly over {} "
            "hosts".format(len(devices), n_hosts)
        )
    per_host = len(devices) // n_hosts
    import numpy as np

    dev_grid = np.array(
        sorted(devices, key=lambda d: (d.process_index, d.id))
    ).reshape(n_hosts, per_host)
    return Mesh(dev_grid, (host_axis, chain_axis))


def mesh_chain_axes(mesh, axis_name=CHAIN_AXIS):
    """The PartitionSpec entry that spreads chains over *all* of ``mesh``.

    For a 1-D :func:`chain_mesh` this is just ``axis_name``; for a
    multi-axis mesh (e.g. :func:`multihost_mesh`) the default chain axis
    expands to the full axis tuple so chains shard over every device.
    An explicitly non-default ``axis_name`` is returned untouched.
    """
    if mesh is not None and axis_name == CHAIN_AXIS and len(mesh.axis_names) > 1:
        return tuple(mesh.axis_names)
    return axis_name


def shard_chains(tree, mesh, axis_name=CHAIN_AXIS):
    """Place every leaf of ``tree`` with its leading axis sharded over ``mesh``."""
    sharding = chain_sharding(mesh, axis_name)
    return jax.tree_util.tree_map(lambda leaf: jax.device_put(leaf, sharding), tree)
