"""Training-dispatch paths the rest of the suite leaves untouched
(coverage-lane findings): the pytree multi-chain path without telemetry
(``log_every=None`` routes past ``_train_chunked``), lanes-path
telemetry, and constructor validation branches."""

import logging
import re

import numpy as np
import pytest

from pysgmcmc_tpu.models.bayesian_neural_network import BayesianNeuralNetwork
from pysgmcmc_tpu.parallel.mesh import chain_mesh

LOG_LINE = re.compile(
    r"Iter\s+(\d+) : NLL = ([-\d.e+]+) MSE = ([-\d.e+]+)"
    r"(?: Samples = (\d+))? Time =\s+[\d.]+"
)


def _sinc_data(seed=1, n=60):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.0, 1.0, (n, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    return x, y


@pytest.mark.slow
def test_multichain_pytree_without_telemetry():
    """n_chains > 1, log_every=None: the single-program vmapped path."""
    bnn = BayesianNeuralNetwork(
        n_chains=4, n_nets=8, n_iters=200, burn_in_steps=60,
        sample_steps=10, batch_size=10, seed=5, units=(8, 8, 8),
        log_every=None,
    )
    x, y = _sinc_data()
    bnn.train(x, y)
    assert bnn.is_trained
    mean, var = bnn.predict(x[:7])
    assert mean.shape == (7,) and var.shape == (7,)
    assert np.isfinite(mean).all() and (var > 0).all()


@pytest.mark.slow
def test_multichain_pytree_mesh_without_telemetry():
    bnn = BayesianNeuralNetwork(
        n_chains=8, n_nets=8, n_iters=100, burn_in_steps=40,
        sample_steps=5, batch_size=10, seed=6, units=(8, 8, 8),
        log_every=None, mesh=chain_mesh(8),
    )
    x, y = _sinc_data()
    bnn.train(x, y)
    assert bnn.is_trained
    mean, _ = bnn.predict(x[:5])
    assert np.isfinite(mean).all()


def test_multichain_mesh_divisibility_checked():
    bnn = BayesianNeuralNetwork(
        n_chains=3, n_nets=3, burn_in_steps=10, sample_steps=5,
        units=(8, 8, 8), log_every=None, mesh=chain_mesh(8),
    )
    x, y = _sinc_data(n=30)
    with pytest.raises(ValueError, match="divisible"):
        bnn.train(x, y)


@pytest.mark.slow
def test_lanes_telemetry_reference_format(caplog):
    """step_impl='lanes' emits the reference-format training logs:
    iteration 0, every log_every burn-in iters, every sample."""
    bnn = BayesianNeuralNetwork(
        step_impl="lanes", n_nets=2, n_iters=200, burn_in_steps=60,
        sample_steps=10, batch_size=10, seed=7, units=(8, 8, 8),
        log_every=30,
    )
    x, y = _sinc_data()
    with caplog.at_level(logging.INFO):
        bnn.train(x, y)
    matches = [
        m for m in (LOG_LINE.search(r.getMessage()) for r in caplog.records)
        if m
    ]
    iters = [int(m.group(1)) for m in matches]
    # iteration 0 + burn-in boundaries (30, 60) + one line per sample
    assert iters[:3] == [0, 30, 60]
    sample_lines = [m for m in matches if m.group(4) is not None]
    assert [int(m.group(4)) for m in sample_lines] == [1, 2]
    assert bnn.is_trained


@pytest.mark.slow
def test_lanes_without_telemetry_trains(caplog):
    bnn = BayesianNeuralNetwork(
        step_impl="lanes", n_nets=2, n_iters=200, burn_in_steps=50,
        sample_steps=10, batch_size=10, seed=8, units=(8, 8, 8),
        log_every=None,
    )
    x, y = _sinc_data()
    with caplog.at_level(logging.INFO):
        bnn.train(x, y)
    assert not any(
        LOG_LINE.search(r.getMessage()) for r in caplog.records)
    assert bnn.is_trained


def test_ctor_validation_branches():
    with pytest.raises(ValueError, match="network"):
        BayesianNeuralNetwork(network="bogus")
    with pytest.raises(ValueError, match="step_impl"):
        BayesianNeuralNetwork(step_impl="bogus")
    with pytest.raises(ValueError, match="units"):
        BayesianNeuralNetwork(units=(0, 8, 8))
