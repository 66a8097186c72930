"""Final coverage-lane sweep: FusedSGHMC runs and batch broadcasting,
regression-model validation/PSGLD branches, gmm objective presets, the
shuffled-batch default seed, and the SampleStore compile-from-source
path."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.data_batches import generate_shuffled_batches
from pysgmcmc_tpu.diagnostics.objective_functions import (
    gmm1_log_likelihood,
    gmm2_log_likelihood,
    gmm3_log_likelihood,
)
from pysgmcmc_tpu.models.bayesian_linear_regression import (
    BayesianLinearRegression,
)
from pysgmcmc_tpu.models.bayesian_logistic_regression import (
    BayesianLogisticRegression,
)
from pysgmcmc_tpu.sampling import Sampler
from pysgmcmc_tpu.samplers.fused import FusedSGHMC
from pysgmcmc_tpu.utils import sample_store as sample_store_mod
from pysgmcmc_tpu.utils.sample_store import SampleStore


#  FusedSGHMC ---------------------------------------------------------------


def _template():
    return {"w": jnp.zeros((3,)), "b": jnp.zeros(())}


def _stacked(n):
    key = jax.random.PRNGKey(0)
    return {
        "w": 0.1 * jax.random.normal(key, (n, 3)),
        "b": jnp.zeros((n,)),
    }


def test_fused_sghmc_backend_validation():
    """The backend option went with the hand-written kernel."""
    with pytest.raises(TypeError, match="backend"):
        FusedSGHMC(lambda p: 0.0, _template(), backend="xla")


def test_fused_sghmc_xla_backend_needs_key():
    fused = FusedSGHMC(
        lambda p: 0.5 * jnp.sum(p["w"] ** 2) + 0.5 * p["b"] ** 2,
        _template(), burn_in_steps=2,
    )
    state = fused.init(_stacked(4))
    with pytest.raises(ValueError, match="key"):
        fused.step(state)


def test_fused_sghmc_xla_backend_runs():
    def cost_fn(p):
        return 0.5 * jnp.sum(p["w"] ** 2) + 0.5 * p["b"] ** 2

    fused = FusedSGHMC(
        cost_fn, _template(), burn_in_steps=3,
        stepsize=0.01, compute_dtype=jnp.bfloat16,
    )
    state = fused.init(_stacked(4))
    state, costs = fused.run(state, jax.random.PRNGKey(1), 8)
    assert costs.shape == (4,)
    assert np.isfinite(np.asarray(costs)).all()
    assert int(state.step) == 8


def test_fused_sghmc_shared_batches_broadcast():
    def cost_fn(p, batch):
        return 0.5 * jnp.sum((p["w"] - jnp.mean(batch)) ** 2) \
            + 0.5 * p["b"] ** 2

    fused = FusedSGHMC(cost_fn, _template(), burn_in_steps=2)
    state = fused.init(_stacked(4))
    state, costs = fused.run(
        state, jax.random.PRNGKey(2), 5,
        batch_fn=lambda key: jax.random.uniform(key, (6,)),
        per_chain_batches=False,
    )
    assert costs.shape == (4,)
    assert np.isfinite(np.asarray(costs)).all()


#  regression models ----------------------------------------------------------


def test_regression_models_reject_unsupported_method():
    with pytest.raises(ValueError, match="sampling_method"):
        BayesianLinearRegression(sampling_method="bogus")
    with pytest.raises(ValueError, match="sampling_method"):
        BayesianLogisticRegression(sampling_method="bogus")


def test_regression_models_accept_float_schedule():
    blr = BayesianLinearRegression(stepsize_schedule=1e-3)
    assert blr.stepsize_schedule.initial_value == 1e-3
    blog = BayesianLogisticRegression(stepsize_schedule=1e-2)
    assert blog.stepsize_schedule.initial_value == 1e-2


@pytest.mark.slow
def test_regression_models_psgld_branch():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (40, 2))
    y_lin = x @ np.asarray([1.0, -2.0]) + 0.1 * rng.standard_normal(40)
    blr = BayesianLinearRegression(
        sampling_method=Sampler.PSGLD, n_nets=4, burn_in_steps=50,
        sample_steps=5, stepsize_schedule=1e-3,
    )
    blr.train(x, y_lin)
    mean, var = blr.predict(x[:5])
    assert mean.shape == (5,) and np.isfinite(mean).all()

    y_cls = (x @ np.asarray([1.0, -2.0]) > 0).astype(np.float64)
    blog = BayesianLogisticRegression(
        sampling_method=Sampler.PSGLD, n_nets=4, burn_in_steps=50,
        sample_steps=5, stepsize_schedule=1e-3,
    )
    blog.train(x, y_cls)
    proba, _ = blog.predict(x[:5])
    assert proba.shape == (5,)
    assert np.all((proba >= 0) & (proba <= 1))


#  gmm objective presets -------------------------------------------------------


def test_gmm_presets_and_list_input():
    x = jnp.asarray([0.5])
    # a length-1 list is unwrapped like the reference's numpy path
    from_list = gmm1_log_likelihood([x])
    from_array = gmm1_log_likelihood(x)
    np.testing.assert_allclose(
        np.asarray(from_list), np.asarray(from_array))
    # the three presets differ only in their variance tuples
    v1 = float(gmm1_log_likelihood(x))
    v2 = float(gmm2_log_likelihood(x))
    v3 = float(gmm3_log_likelihood(x))
    assert len({round(v, 6) for v in (v1, v2, v3)}) == 3


def test_shuffled_batches_default_seed():
    x = np.arange(20.0).reshape(10, 2)
    y = np.arange(10.0)
    xb, yb = next(generate_shuffled_batches(x, y, batch_size=4))
    assert xb.shape == (4, 2) and yb.shape == (4, 1)


#  SampleStore compile-from-source ---------------------------------------------


def test_sample_store_builds_from_source(tmp_path, monkeypatch):
    """A fresh checkout (no .so) compiles the C++ ring buffer on demand."""
    monkeypatch.setattr(sample_store_mod, "_lib", None)
    monkeypatch.setattr(
        sample_store_mod, "_LIB", os.fspath(tmp_path / "libsample_store.so"))
    store = SampleStore(capacity=4, width=2)
    store.append(np.ones((6, 2), np.float32))  # wraps: keeps the last 4
    assert len(store) == 4
    assert store.total_appended == 6
    monkeypatch.setattr(sample_store_mod, "_lib", None)  # don't leak the lib
