import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.ops.pairwise import median_bandwidth, squared_distance_matrix
from pysgmcmc_tpu.ops.svgd_streaming import svgd_phi_streaming


def _xla_phi(x, g, h):
    d2 = squared_distance_matrix(x)
    kernel = jnp.exp(-d2 / (2 * h**2))
    ksum = kernel.sum(axis=1)
    grad_kernel = (x * ksum[:, None] - kernel @ x) / h**2
    return (kernel @ (-g) + grad_kernel) / x.shape[0]


@pytest.mark.parametrize("n,d,tile", [(256, 3, 64), (128, 130, 32),
                                      (64, 1, 64), (512, 17, 512)])
def test_streaming_matches_xla(n, d, tile):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    g = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    h = float(median_bandwidth(squared_distance_matrix(x), n))
    expected = _xla_phi(x, g, h)
    got = svgd_phi_streaming(x, g, h, tile=tile)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(expected), rtol=1e-4, atol=1e-5
    )


def _reference_svgd(x, n_steps, eps, alpha=0.9, fudge=1e-6):
    """Plain float64 SVGD on the standard normal (cost 0.5 |x|^2): dense
    transport, median bandwidth, Adagrad — the sampler's update rule."""
    x = np.asarray(x, np.float64)
    hist = np.zeros_like(x)
    n = x.shape[0]
    for _ in range(n_steps):
        sq = np.sum(x * x, axis=1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * x @ x.T, 0.0)
        h = np.sqrt(0.5 * np.median(d2) / np.log(n + 1.0))
        k = np.exp(-d2 / (2.0 * h * h))
        phi = (k @ (-x) + (x * k.sum(axis=1)[:, None] - k @ x) / h**2) / n
        hist = alpha * hist + (1.0 - alpha) * phi**2
        x = x + eps * phi / (fudge + np.sqrt(hist))
    return x


def test_sampler_streaming_impl_matches_dense():
    """SVGDSampler(kernel_impl='streaming') reproduces the dense SVGD step
    when the bandwidth subsample covers all particles.  The dense
    reference runs in float64: the float32 dense path's own rounding,
    amplified by five Adagrad steps, is as large as the tolerance."""
    from pysgmcmc_tpu.samplers.svgd import SVGDSampler

    cost_fn = lambda x: 0.5 * jnp.sum(x**2)
    particles = jax.random.normal(jax.random.PRNGKey(0), (64, 2)) * 2.0

    stream = SVGDSampler(
        cost_fn, stepsize_schedule=0.3, kernel_impl="streaming",
        streaming_tile=32,
    )
    state_s = stream.init(particles)
    for i in range(5):
        state_s, _ = stream.step(state_s, jax.random.PRNGKey(i))
    np.testing.assert_allclose(
        np.asarray(state_s.position), _reference_svgd(particles, 5, 0.3),
        rtol=1e-4, atol=1e-6,
    )


@pytest.mark.parametrize("n,d,tile", [
    (100, 2, 64), (97, 5, 32), (130, 3, 128), (7, 4, 3), (33, 129, 16),
    (200, 1, 199), (50, 8, 1000),
])
def test_arbitrary_n_padded_and_masked(n, d, tile):
    """n that does not divide the tile is padded; padded columns must not
    perturb the result (masked out of every reduction)."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    g = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    h = float(median_bandwidth(squared_distance_matrix(x), n))
    expected = _xla_phi(x, g, h)
    got = svgd_phi_streaming(x, g, h, tile=tile)
    assert got.shape == (n, d)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(expected), rtol=1e-4, atol=1e-5
    )


def test_bandwidth_subsample_unbiased_under_ordering():
    """With a random subsample, a sorted ensemble estimates (approximately)
    the same bandwidth as the exact all-particle median; the old first-k
    subsample was badly biased on ordered ensembles."""
    from pysgmcmc_tpu.samplers.svgd import SVGDSampler

    rng = np.random.default_rng(2)
    n, d = 512, 2
    particles = np.sort(rng.normal(size=(n, d)).astype(np.float32), axis=0)

    cost_fn = lambda x: 0.5 * jnp.sum(x**2)
    sampler = SVGDSampler(
        cost_fn, kernel_impl="streaming", bandwidth_subsample=128,
        streaming_tile=128,
    )
    x = jnp.asarray(particles)
    h_exact = float(median_bandwidth(squared_distance_matrix(x), n))

    # reproduce the sampler's subsample draw for a fixed step key
    key = jax.random.PRNGKey(7)
    idx = jax.random.randint(jax.random.fold_in(key, 1), (128,), 0, n)
    sub = x[idx]
    h_sub = float(median_bandwidth(squared_distance_matrix(sub), n))
    assert abs(h_sub - h_exact) / h_exact < 0.25

    # first-k on the sorted ensemble is the failure mode we removed
    h_firstk = float(median_bandwidth(squared_distance_matrix(x[:128]), n))
    assert abs(h_firstk - h_exact) / h_exact > abs(h_sub - h_exact) / h_exact

    # and the full sampler step runs on the ordered ensemble
    state = sampler.init(x)
    state, _ = sampler.step(state, key)
    assert np.isfinite(np.asarray(state.position)).all()
