"""Options of the removed hand-written kernel path fail loudly.

The model forwards unknown keywords to its sampler, so the constructor
itself must reject the removed options with a message that names the
replacement; the drivers and samplers no longer accept them at all.
"""

import jax
import jax.numpy as jnp
import pytest

from pysgmcmc_tpu.models import BayesianNeuralNetwork
from pysgmcmc_tpu.parallel import packed
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler
from pysgmcmc_tpu.samplers.svgd import SVGDSampler


@pytest.mark.parametrize("kwargs", [
    dict(step_impl="fused"),
    dict(pair_dots=True),
    dict(noise_impl="hadamard_clt"),
    dict(backend="pallas"),
    dict(interpret=True),
], ids=["step_impl", "pair_dots", "noise_impl", "backend", "interpret"])
def test_model_rejects_removed_option(kwargs):
    with pytest.raises(ValueError, match="removed") as err:
        BayesianNeuralNetwork(**kwargs)
    assert "step_impl='pytree'" in str(err.value)


def _cost(x):
    return 0.5 * jnp.sum(x**2)


@pytest.mark.parametrize("driver", [
    "burnin_chain_lanes", "sample_chain_stacked", "sample_chain_packed",
])
def test_driver_rejects_backend(driver):
    sampler = SGHMCSampler(_cost, burn_in_steps=1)
    states = jax.vmap(sampler.init)(
        jnp.zeros((4, 3)), jax.random.split(jax.random.PRNGKey(0), 4))
    with pytest.raises(TypeError, match="backend"):
        getattr(packed, driver)(
            sampler, states, jax.random.PRNGKey(1), 1, backend="pallas")


def test_svgd_rejects_streaming_interpret():
    with pytest.raises(TypeError, match="streaming_interpret"):
        SVGDSampler(_cost, kernel_impl="streaming", streaming_interpret=True)
