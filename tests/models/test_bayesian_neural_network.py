import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.diagnostics.objective_functions import sinc
from pysgmcmc_tpu.models import BayesianNeuralNetwork, default_network
from pysgmcmc_tpu.sampling import Sampler


def _sinc_data(seed=1, n=100):
    rng = np.random.RandomState(seed)
    x_train = rng.uniform(0.0, 1.0, (n, 1))
    y_train = np.asarray(sinc(x_train))
    x_test = np.linspace(0, 1, 100)[:, None]
    y_test = np.asarray(sinc(x_test))
    return x_train, y_train, x_test, y_test


def _fast_bnn(**kwargs):
    defaults = dict(burn_in_steps=1000, n_nets=10, seed=1)
    defaults.update(kwargs)
    return BayesianNeuralNetwork(**defaults)


@pytest.mark.parametrize("normalize_input", [True, False])
@pytest.mark.parametrize("normalize_output", [True, False])
@pytest.mark.slow
def test_train_predict_performance(normalize_input, normalize_output):
    """Sinc regression MSE close to 0 for all normalization combos.

    Mirrors the reference gate
    (``tests/bayesian_neural_network/test_train_predict.py:49``, atol 1e-1).
    """
    x_train, y_train, x_test, y_test = _sinc_data()
    bnn = _fast_bnn(
        normalize_input=normalize_input, normalize_output=normalize_output
    )
    bnn.train(x_train, y_train)
    assert bnn.is_trained
    mean, variance = bnn.predict(x_test)
    mse = float(np.mean((mean - y_test) ** 2))
    assert np.allclose(mse, 0.0, atol=1e-1)
    assert np.all(variance >= 0)


def test_predict_before_train_raises():
    x_test = np.linspace(0, 1, 100)[:, None]
    bnn = _fast_bnn()
    with pytest.raises(ValueError):
        bnn.predict(x_test)


@pytest.mark.slow
def test_individual_predictions_length():
    """return_individual_predictions yields n_nets member predictions
    (cf. reference ``test_train_predict.py:74-113``)."""
    x_train, y_train, x_test, _ = _sinc_data()
    n_nets = 7
    bnn = _fast_bnn(n_nets=n_nets, burn_in_steps=200, sample_steps=20)
    bnn.train(x_train, y_train)
    f_out, theta_noise = bnn.predict(x_test, return_individual_predictions=True)
    assert f_out.shape == (n_nets, x_test.shape[0])
    assert theta_noise.shape == (n_nets, x_test.shape[0])
    assert np.all(theta_noise > 0)


@pytest.mark.slow
def test_mixed_precision_compute():
    """bf16 network compute keeps the sinc quality gate (f32 state)."""
    x_train, y_train, x_test, y_test = _sinc_data()
    bnn = _fast_bnn(compute_dtype=jnp.bfloat16)
    bnn.train(x_train, y_train)
    mean, _ = bnn.predict(x_test)
    mse = float(np.mean((mean - y_test) ** 2))
    assert np.allclose(mse, 0.0, atol=1e-1)
    # sampler state stays f32
    assert all(
        leaf.dtype == jnp.float32
        for leaf in jax.tree_util.tree_leaves(bnn.samples)
    )


@pytest.mark.slow
def test_train_with_sgld():
    x_train, y_train, x_test, y_test = _sinc_data()
    bnn = _fast_bnn(
        sampling_method=Sampler.SGLD,
        stepsize_schedule=1e-5,
        burn_in_steps=1000,
        n_nets=5,
    )
    bnn.train(x_train, y_train)
    mean, _ = bnn.predict(x_test)
    assert np.all(np.isfinite(mean))


@pytest.mark.slow
def test_train_with_relativistic_sghmc():
    x_train, y_train, x_test, _ = _sinc_data()
    bnn = _fast_bnn(
        sampling_method=Sampler.RelativisticSGHMC,
        stepsize_schedule=0.001,
        n_nets=5,
        burn_in_steps=0,
    )
    bnn.train(x_train, y_train)
    mean, _ = bnn.predict(x_test)
    assert np.all(np.isfinite(mean))


@pytest.mark.slow
def test_train_with_svgd_ensemble():
    """SVGD trains the whole particle-network ensemble jointly — the
    capability the reference's BNN explicitly lacked (``svgd.py:7-10``)."""
    x_train, y_train, x_test, y_test = _sinc_data()
    bnn = BayesianNeuralNetwork(
        sampling_method=Sampler.SVGD,
        stepsize_schedule=1e-3,
        n_nets=8,
        n_iters=1500,
        seed=1,
    )
    bnn.train(x_train, y_train)
    f_out, theta_noise = bnn.predict(x_test, return_individual_predictions=True)
    assert f_out.shape == (8, 100)
    mean, _ = bnn.predict(x_test)
    mse = float(np.mean((mean - y_test) ** 2))
    assert np.isfinite(mse)
    # particles stay distinct (repulsion prevents collapse)
    assert np.std(f_out, axis=0).mean() > 1e-6


@pytest.mark.slow
def test_seeding_reproducible():
    """Same seed -> identical posterior samples and predictions
    (cf. reference ``test_seeding.py:14-46``, strengthened to exact)."""
    x_train, y_train, x_test, _ = _sinc_data()
    preds = []
    for _ in range(2):
        bnn = _fast_bnn(n_nets=3, burn_in_steps=100, sample_steps=10, seed=7)
        bnn.train(x_train, y_train)
        mean, var = bnn.predict(x_test)
        preds.append((mean, var))
    np.testing.assert_array_equal(preds[0][0], preds[1][0])
    np.testing.assert_array_equal(preds[0][1], preds[1][1])


def test_invalid_inputs():
    """Ctor argument validation (cf. reference ``test_invalid_inputs.py``)."""
    for bad in [0, -1, 1.5, "x", None]:
        with pytest.raises((ValueError, AssertionError)):
            BayesianNeuralNetwork(n_nets=bad)
        with pytest.raises((ValueError, AssertionError)):
            BayesianNeuralNetwork(batch_size=bad)
        with pytest.raises((ValueError, AssertionError)):
            BayesianNeuralNetwork(sample_steps=bad)
        with pytest.raises((ValueError, AssertionError)):
            BayesianNeuralNetwork(n_iters=bad)
    with pytest.raises((ValueError, AssertionError)):
        BayesianNeuralNetwork(burn_in_steps=-1)
    with pytest.raises(ValueError):
        BayesianNeuralNetwork(sampling_method="not a sampler")


@pytest.mark.slow
def test_iteration_budget():
    """n_iters caps collection; too-small budgets raise."""
    x_train, y_train, _, _ = _sinc_data()
    bnn = BayesianNeuralNetwork(
        n_nets=100, n_iters=300, burn_in_steps=100, sample_steps=100, seed=0
    )
    bnn.train(x_train, y_train)
    assert bnn._n_collected == 2

    bad = BayesianNeuralNetwork(
        n_nets=10, n_iters=50, burn_in_steps=100, sample_steps=100, seed=0
    )
    with pytest.raises(ValueError):
        bad.train(x_train, y_train)


@pytest.mark.slow
def test_update_appends_and_retrains():
    x_train, y_train, x_test, _ = _sinc_data(n=50)
    bnn = _fast_bnn(n_nets=3, burn_in_steps=100, sample_steps=10)
    bnn.train(x_train, y_train)
    more_x, more_y, _, _ = _sinc_data(seed=2, n=10)
    bnn.update(more_x, more_y)
    assert bnn.is_trained
    mean, _ = bnn.predict(x_test)
    assert mean.shape == (100,)


@pytest.mark.slow
def test_get_incumbent():
    x_train, y_train, _, _ = _sinc_data(n=30)
    bnn = _fast_bnn(n_nets=2, burn_in_steps=50, sample_steps=5)
    bnn.train(x_train, y_train)
    x_best, y_best = bnn.get_incumbent()
    assert y_best == y_train.min()
    np.testing.assert_array_equal(x_best, x_train[np.argmin(y_train)])


def test_default_network_seeded_init():
    """Identical keys give identical weights (cf. reference test_seeding)."""
    init, apply = default_network(3)
    p1 = init(jax.random.PRNGKey(0))
    p2 = init(jax.random.PRNGKey(0))
    for name in p1:
        np.testing.assert_array_equal(np.asarray(p1[name]), np.asarray(p2[name]))
    assert p1["w1"].shape == (3, 50)
    assert p1["w4"].shape == (50, 1)
    assert float(p1["log_variance_bias"][0, 0]) == pytest.approx(np.log(1e-3))
    out = apply(p1, jnp.zeros((4, 3)))
    assert out.shape == (4, 2)


@pytest.mark.slow
def test_train_with_psgld():
    """pSGLD (beyond-reference) trains the BNN."""
    x_train, y_train, x_test, _ = _sinc_data()
    bnn = _fast_bnn(
        sampling_method=Sampler.PSGLD,
        stepsize_schedule=1e-3,
        burn_in_steps=0,
        n_nets=5,
    )
    bnn.train(x_train, y_train)
    mean, _ = bnn.predict(x_test)
    assert np.all(np.isfinite(mean))


@pytest.mark.slow
def test_train_with_sgnht():
    """SGNHT (beyond-reference, Ding et al. 2014) trains the BNN."""
    x_train, y_train, x_test, _ = _sinc_data()
    bnn = _fast_bnn(
        sampling_method=Sampler.SGNHT,
        stepsize_schedule=1e-3,
        burn_in_steps=0,
        n_nets=5,
    )
    bnn.train(x_train, y_train)
    mean, _ = bnn.predict(x_test)
    assert np.all(np.isfinite(mean))


@pytest.mark.slow
def test_dense_network_option_trains():
    """network='dense' (lane-friendly parameterization) trains and predicts."""
    x, y = _sinc_data()[:2]
    bnn = BayesianNeuralNetwork(
        network="dense", n_nets=5, n_iters=400, burn_in_steps=200,
        sample_steps=20, seed=1)
    bnn.train(x, y)
    mean, variance = bnn.predict(x)
    assert np.all(np.isfinite(mean))
    assert np.all(variance >= 0)


@pytest.mark.slow
def test_lanes_step_impl_all_samplers():
    """step_impl='lanes' trains with every gradient-based sampler."""
    from pysgmcmc_tpu.sampling import Sampler

    x, y = _sinc_data()[:2]
    for method, kw in (
        (Sampler.SGHMC, {}),
        (Sampler.SGLD, {"stepsize_schedule": 1e-5}),
        (Sampler.PSGLD, {"stepsize_schedule": 1e-4}),
        (Sampler.RelativisticSGHMC, {"stepsize_schedule": 1e-3}),
        (Sampler.SGNHT, {"stepsize_schedule": 1e-3}),
    ):
        bnn = BayesianNeuralNetwork(
            sampling_method=method, step_impl="lanes", n_chains=2,
            n_nets=4, n_iters=300, burn_in_steps=100, sample_steps=10,
            batch_size=10, log_every=None, seed=3, **kw)
        bnn.train(x, y)
        mean, variance = bnn.predict(x)
        assert bnn._n_collected == 4
        assert np.all(np.isfinite(mean)), method
        assert np.all(variance >= 0), method

    import pytest

    with pytest.raises(ValueError, match="lanes"):
        BayesianNeuralNetwork(step_impl="lanes", sampling_method=Sampler.SVGD)


def test_lanes_step_impl_fast_smoke():
    """Tiny lanes-path training smoke for the fast CI lane (the full
    all-samplers sweep is @slow)."""
    x, y = _sinc_data()[:2]
    bnn = BayesianNeuralNetwork(
        step_impl="lanes", n_chains=2, n_nets=2, n_iters=120,
        burn_in_steps=30, sample_steps=20, seed=5, log_every=None,
        units=(8, 8, 8))
    bnn.train(x, y)
    mean, _ = bnn.predict(x)
    assert np.all(np.isfinite(mean))


@pytest.mark.slow
@pytest.mark.parametrize("impl", ["pytree", "lanes"])
def test_kernel_step_impls_train_under_mesh(impl):
    """Both step_impls compose with the chain mesh: train end to end on
    the 8-device virtual mesh, one chain per shard."""
    from pysgmcmc_tpu.parallel.mesh import chain_mesh

    x, y = _sinc_data()[:2]
    bnn = BayesianNeuralNetwork(
        network="dense", step_impl=impl, mesh=chain_mesh(8), n_chains=8,
        n_nets=8, n_iters=60, burn_in_steps=20, sample_steps=20,
        log_every=None, seed=0)
    bnn.train(x, y)
    mean, variance = bnn.predict(x)
    assert np.all(np.isfinite(mean))
    assert np.all(variance >= 0)

    with pytest.raises(ValueError, match="divisible by the mesh size"):
        BayesianNeuralNetwork(
            network="dense", step_impl=impl, mesh=chain_mesh(8),
            n_chains=12, n_nets=12, log_every=None).train(x, y)
