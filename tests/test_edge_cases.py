"""Edge-case coverage for containers and meshes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.diagnostics.sample_chains import MultiTrace, PYSGMCMCTrace
from pysgmcmc_tpu.parallel.mesh import chain_mesh


def test_chain_mesh_too_many_devices():
    with pytest.raises(ValueError):
        chain_mesh(999)


def test_trace_inconsistent_sample_counts():
    with pytest.raises(ValueError):
        PYSGMCMCTrace(0, [jnp.zeros(5), jnp.zeros(6)], varnames=["a", "b"])


def test_trace_varname_count_mismatch():
    with pytest.raises(ValueError):
        PYSGMCMCTrace(0, [jnp.zeros(5)], varnames=["a", "b"])


def test_multitrace_varname_disagreement():
    t1 = PYSGMCMCTrace(0, jnp.zeros(4), varnames=["a"])
    t2 = PYSGMCMCTrace(1, jnp.zeros(4), varnames=["b"])
    with pytest.raises(ValueError):
        MultiTrace([t1, t2])
    with pytest.raises(ValueError):
        MultiTrace([])


def test_multitrace_len_is_min():
    t1 = PYSGMCMCTrace(0, jnp.zeros(4), varnames=["a"])
    t2 = PYSGMCMCTrace(1, jnp.zeros(7), varnames=["a"])
    assert len(MultiTrace([t1, t2])) == 4


def test_empty_trace_rejected():
    with pytest.raises(ValueError):
        PYSGMCMCTrace(0, [])


def test_effective_sample_size_bad_rank():
    from pysgmcmc_tpu.diagnostics.sampler_diagnostics import (
        effective_sample_size,
    )

    with pytest.raises(ValueError):
        effective_sample_size(jnp.zeros(10))
