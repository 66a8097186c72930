"""Multi-host (2-axis hosts x chips) mesh support.

Runs on the virtual 8-device CPU mesh: ``multihost_mesh(n_hosts=2)``
emulates a 2-host x 4-chip topology.  Chains shard over *both* axes and
must be bitwise identical to the unsharded vmap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.parallel.chains import run_chains, stack_positions
from pysgmcmc_tpu.parallel.mesh import (
    CHAIN_AXIS,
    HOST_AXIS,
    chain_mesh,
    initialize_multihost,
    mesh_chain_axes,
    multihost_mesh,
)
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler


def _sampler():
    return SGHMCSampler(
        lambda x: 0.5 * jnp.sum(x**2), stepsize_schedule=0.05,
        burn_in_steps=10,
    )


def test_multihost_mesh_shape():
    mesh = multihost_mesh(n_hosts=2)
    n = len(jax.devices())
    assert mesh.devices.shape == (2, n // 2)
    assert mesh.axis_names == (HOST_AXIS, CHAIN_AXIS)


def test_multihost_mesh_uneven_raises():
    with pytest.raises(ValueError, match="split evenly"):
        multihost_mesh(n_hosts=3)


def test_mesh_chain_axes_expansion():
    mesh2d = multihost_mesh(n_hosts=2)
    assert mesh_chain_axes(mesh2d) == (HOST_AXIS, CHAIN_AXIS)
    # explicit non-default names are untouched
    assert mesh_chain_axes(mesh2d, ("a", "b")) == ("a", "b")
    mesh1d = chain_mesh(2)
    assert mesh_chain_axes(mesh1d) == CHAIN_AXIS
    assert mesh_chain_axes(None) == CHAIN_AXIS


def test_chains_on_2d_mesh_match_unsharded():
    """Sharding chains over a hosts x chips mesh is bitwise neutral."""
    mesh = multihost_mesh(n_hosts=2)
    n_chains = 2 * mesh.devices.size
    sampler = _sampler()
    positions = stack_positions(
        jnp.ones(3), n_chains, jitter=0.1, key=jax.random.PRNGKey(0)
    )
    key = jax.random.PRNGKey(1)

    ref_chains, ref_costs = run_chains(sampler, positions, key, 5)
    got_chains, got_costs = run_chains(
        sampler, positions, key, 5, mesh=mesh
    )
    np.testing.assert_array_equal(np.asarray(ref_chains), np.asarray(got_chains))
    np.testing.assert_array_equal(np.asarray(ref_costs), np.asarray(got_costs))

    # outputs really spread over every device of the 2-D mesh
    n_dev = len({s.device for s in got_costs.addressable_shards})
    assert n_dev == mesh.devices.size


def test_initialize_multihost_single_process_noop():
    """In a single-process context initialization must be a harmless no-op."""
    initialize_multihost()
    initialize_multihost()  # idempotent
    assert jax.process_count() == 1


#  Cluster-mode branches, simulated by stubbing jax.distributed.initialize
#  (a real coordinator barrier needs multiple processes).  These pin the
#  behavior that matters operationally: explicit cluster args NEVER
#  degrade silently into a single-process run.


@pytest.fixture
def _fresh_multihost_state(monkeypatch):
    from pysgmcmc_tpu.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_DISTRIBUTED_INITIALIZED", False)
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    return mesh_mod


def test_initialize_multihost_explicit_args_forwarded(
        _fresh_multihost_state, monkeypatch):
    mesh_mod = _fresh_multihost_state
    calls = []
    monkeypatch.setattr(
        jax.distributed, "initialize",
        lambda **kw: calls.append(kw))
    initialize_multihost(
        coordinator_address="10.0.0.1:1234", num_processes=4, process_id=2)
    assert calls == [dict(
        coordinator_address="10.0.0.1:1234", num_processes=4, process_id=2)]
    assert mesh_mod._DISTRIBUTED_INITIALIZED


def test_initialize_multihost_explicit_failure_raises(
        _fresh_multihost_state, monkeypatch):
    def boom(**kw):
        raise RuntimeError(
            "jax.distributed.initialize() must be called before "
            "the backend is initialized")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    # an explicit cluster request must NOT silently proceed standalone
    with pytest.raises(RuntimeError):
        initialize_multihost(
            coordinator_address="10.0.0.1:1234", num_processes=4,
            process_id=0)


def test_initialize_multihost_already_initialized_ok(
        _fresh_multihost_state, monkeypatch):
    mesh_mod = _fresh_multihost_state

    def already(**kw):
        raise RuntimeError("distributed runtime already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", already)
    initialize_multihost(
        coordinator_address="10.0.0.1:1234", num_processes=4, process_id=0)
    assert mesh_mod._DISTRIBUTED_INITIALIZED


def test_initialize_multihost_autodetect_requires_cluster_env(
        _fresh_multihost_state, monkeypatch):
    calls = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: calls.append(kw))
    initialize_multihost()  # no cluster advertised: never touches JAX
    assert calls == []

    # an empty variable advertises nothing
    monkeypatch.setenv("JAX_NUM_PROCESSES", "")
    initialize_multihost()
    assert calls == []

    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    initialize_multihost()
    assert len(calls) == 1


def test_initialize_multihost_autodetect_failure_warns_not_raises(
        _fresh_multihost_state, monkeypatch, caplog):
    import logging

    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    with caplog.at_level(logging.WARNING):
        initialize_multihost()  # best-effort, but loudly
    assert any("single-process" in r.getMessage() for r in caplog.records)
