"""In-training telemetry (reference parity: full-train NLL/MSE logs).

The reference logs the full-training-set NLL/MSE every 512 burn-in
iterations and at every collected sample
(``/root/reference/pysgmcmc/models/bayesian_neural_network.py:472-519``).
Here the compiled training scan is chunked at the log boundaries.
"""

import logging
import re

import numpy as np
import pytest

from pysgmcmc_tpu.models.bayesian_neural_network import BayesianNeuralNetwork

LOG_LINE = re.compile(
    r"Iter\s+(\d+) : NLL = ([-\d.e+]+) MSE = ([-\d.e+]+)"
    r"(?: Samples = (\d+))? Time =\s+[\d.]+"
)


def _sinc_data(seed=1, n=60):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.0, 1.0, (n, 1))
    y = np.sinc(x[:, 0] * 10 - 5)
    return x, y


def _train(caplog, **kwargs):
    defaults = dict(
        n_nets=3, n_iters=200, burn_in_steps=100, sample_steps=10,
        batch_size=10, seed=3, units=(8, 8, 8),
    )
    defaults.update(kwargs)
    bnn = BayesianNeuralNetwork(**defaults)
    x, y = _sinc_data()
    with caplog.at_level(logging.INFO):
        bnn.train(x, y)
    return bnn, [
        m for m in (LOG_LINE.search(r.getMessage()) for r in caplog.records)
        if m
    ]


def test_burn_in_and_sampling_logs(caplog):
    """Logs at iteration 0, every log_every burn-in iters, every sample."""
    bnn, matches = _train(caplog, log_every=50)
    iters = [int(m.group(1)) for m in matches]
    # burn-in boundary logs: 0, 50, 100; then one per collected sample
    assert iters[:3] == [0, 50, 100]
    sampling = [m for m in matches if m.group(4) is not None]
    assert [int(m.group(4)) for m in sampling] == [1, 2, 3]
    # the metric values are finite floats
    for m in matches:
        assert np.isfinite(float(m.group(2)))
        assert np.isfinite(float(m.group(3)))
    assert bnn.is_trained
    assert bnn._n_collected == 3


@pytest.mark.slow
def test_ragged_burn_in_segments(caplog):
    """burn_in_steps not divisible by log_every -> remainder segment."""
    bnn, matches = _train(caplog, log_every=64, burn_in_steps=100)
    iters = [int(m.group(1)) for m in matches if m.group(4) is None]
    assert iters == [0, 64, 100]


def test_telemetry_off_is_single_scan(caplog):
    """log_every=None keeps the original one-scan program (no Iter logs)."""
    bnn, matches = _train(caplog, log_every=None)
    assert matches == []
    assert bnn.is_trained


@pytest.mark.slow
def test_multichain_telemetry(caplog):
    """Multi-chain training logs chain-mean metrics and pools samples."""
    bnn, matches = _train(
        caplog, log_every=50, n_chains=2, n_nets=4, sample_steps=20,
    )
    sampling = [m for m in matches if m.group(4) is not None]
    # 2 samples per chain x 2 chains, logged as cumulative pooled counts
    assert [int(m.group(4)) for m in sampling] == [2, 4]
    assert bnn._n_collected == 4
    leaves = np.asarray(
        np.concatenate(
            [np.ravel(l) for l in
             __import__("jax").tree_util.tree_leaves(bnn.samples)]
        )
    )
    assert np.isfinite(leaves).all()


def test_log_every_validation():
    with pytest.raises(ValueError, match="log_every"):
        BayesianNeuralNetwork(log_every=0)
    with pytest.raises(ValueError, match="log_every"):
        BayesianNeuralNetwork(log_every=2.5)


@pytest.mark.slow
def test_telemetry_deterministic(caplog):
    """Same seed + same log_every -> identical posterior samples."""
    import jax

    samples = []
    for _ in range(2):
        bnn, _ = _train(caplog, log_every=50, seed=11)
        samples.append(bnn.samples)
    for a, b in zip(
        jax.tree_util.tree_leaves(samples[0]),
        jax.tree_util.tree_leaves(samples[1]),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_fused_path_telemetry(caplog):
    """step_impl='lanes' chunks burn-in + per-sample logs like the
    pytree chunked path."""
    bnn, matches = _train(
        caplog, log_every=50, network="dense", step_impl="lanes",
        n_chains=2, n_nets=4, sample_steps=20,
    )
    burn_iters = [int(m.group(1)) for m in matches if m.group(4) is None]
    assert burn_iters == [0, 50, 100]
    sampling = [m for m in matches if m.group(4) is not None]
    assert [int(m.group(4)) for m in sampling] == [2, 4]
    assert bnn._n_collected == 4
