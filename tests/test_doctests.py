"""Doctest execution over the package's docstring examples.

The reference's main behavioral coverage is ``--doctest-modules``
(``/root/reference/pysgmcmc/pytest.ini:1-4``); this runs the same kind of
executable-documentation checks over our modules (collected explicitly so
the jax platform forcing in conftest applies first).
"""

import doctest

import pytest

import pysgmcmc_tpu.data_batches
import pysgmcmc_tpu.diagnostics.arviz_export
import pysgmcmc_tpu.diagnostics.chain_health
import pysgmcmc_tpu.diagnostics.model_diagnostics
import pysgmcmc_tpu.diagnostics.objective_functions
import pysgmcmc_tpu.diagnostics.sample_chains
import pysgmcmc_tpu.diagnostics.sampler_diagnostics
import pysgmcmc_tpu.models.architectures
import pysgmcmc_tpu.models.base_model
import pysgmcmc_tpu.models.bayesian_linear_regression
import pysgmcmc_tpu.models.bayesian_logistic_regression
import pysgmcmc_tpu.models.bayesian_neural_network
import pysgmcmc_tpu.ops.pairwise
import pysgmcmc_tpu.ops.relativistic
import pysgmcmc_tpu.ops.svgd_streaming
import pysgmcmc_tpu.parallel.chains
import pysgmcmc_tpu.parallel.mesh
import pysgmcmc_tpu.parallel.packed
import pysgmcmc_tpu.parallel.svgd
import pysgmcmc_tpu.samplers._adaptive
import pysgmcmc_tpu.samplers.base
import pysgmcmc_tpu.samplers.fused
import pysgmcmc_tpu.samplers.psgld
import pysgmcmc_tpu.samplers.relativistic_sghmc
import pysgmcmc_tpu.samplers.sghmc
import pysgmcmc_tpu.samplers.sgld
import pysgmcmc_tpu.samplers.sgnht
import pysgmcmc_tpu.samplers.svgd
import pysgmcmc_tpu.sampling
import pysgmcmc_tpu.stepsize_schedules
import pysgmcmc_tpu.utils.checkpoint
import pysgmcmc_tpu.utils.device
import pysgmcmc_tpu.utils.numeric
import pysgmcmc_tpu.utils.profiling
import pysgmcmc_tpu.utils.pytree
import pysgmcmc_tpu.utils.sample_store

# Every public module carries executable docstring examples — the analog of
# the reference's --doctest-modules over its whole package
# (/root/reference/pysgmcmc/pytest.ini:1-4).
MODULES = [
    pysgmcmc_tpu.data_batches,
    pysgmcmc_tpu.diagnostics.arviz_export,
    pysgmcmc_tpu.diagnostics.chain_health,
    pysgmcmc_tpu.diagnostics.model_diagnostics,
    pysgmcmc_tpu.diagnostics.objective_functions,
    pysgmcmc_tpu.diagnostics.sample_chains,
    pysgmcmc_tpu.diagnostics.sampler_diagnostics,
    pysgmcmc_tpu.models.architectures,
    pysgmcmc_tpu.models.base_model,
    pysgmcmc_tpu.models.bayesian_linear_regression,
    pysgmcmc_tpu.models.bayesian_logistic_regression,
    pysgmcmc_tpu.models.bayesian_neural_network,
    pysgmcmc_tpu.ops.pairwise,
    pysgmcmc_tpu.ops.relativistic,
    pysgmcmc_tpu.ops.svgd_streaming,
    pysgmcmc_tpu.parallel.chains,
    pysgmcmc_tpu.parallel.mesh,
    pysgmcmc_tpu.parallel.packed,
    pysgmcmc_tpu.parallel.svgd,
    pysgmcmc_tpu.samplers._adaptive,
    pysgmcmc_tpu.samplers.base,
    pysgmcmc_tpu.samplers.fused,
    pysgmcmc_tpu.samplers.psgld,
    pysgmcmc_tpu.samplers.relativistic_sghmc,
    pysgmcmc_tpu.samplers.sghmc,
    pysgmcmc_tpu.samplers.sgld,
    pysgmcmc_tpu.samplers.sgnht,
    pysgmcmc_tpu.samplers.svgd,
    pysgmcmc_tpu.sampling,
    pysgmcmc_tpu.stepsize_schedules,
    pysgmcmc_tpu.utils.checkpoint,
    pysgmcmc_tpu.utils.device,
    pysgmcmc_tpu.utils.numeric,
    pysgmcmc_tpu.utils.profiling,
    pysgmcmc_tpu.utils.pytree,
    pysgmcmc_tpu.utils.sample_store,
]


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_doctests(module):
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0, "{} doctest failures in {}".format(
        results.failed, module.__name__
    )
    assert results.attempted > 0, "no doctests found in {}".format(
        module.__name__
    )
