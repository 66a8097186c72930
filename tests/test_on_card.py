"""Card-only checks: properties that only a GPU can break.

Marked ``gpu``; they skip without a GPU and are run on the card by
``python chip_smoke.py`` (phase 6), inside its process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.data_batches import batch_fn
from pysgmcmc_tpu.ops.pairwise import (
    median_bandwidth,
    squared_distance_matrix,
    svgd_kernel,
)
from pysgmcmc_tpu.ops.svgd_streaming import svgd_phi_streaming

pytestmark = pytest.mark.gpu


def test_batch_selector_exact_on_card(gpu):
    """Minibatches hold the data's exact float32 values on the card (a
    matmul at default precision may round them to TF32)."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.uniform(size=(100, 3)), jnp.float32)
    y = jnp.asarray(rng.uniform(size=(100,)), jnp.float32)
    select = batch_fn(x, y, 20)
    # one window per chain of the 8192-chain flagship
    keys = jax.random.split(jax.random.PRNGKey(0), 8192)
    xb, yb = jax.jit(jax.vmap(select))(keys)
    starts = jax.vmap(lambda k: jax.random.randint(k, (), 0, 81))(keys)
    rows = np.asarray(starts)[:, None] + np.arange(20)
    np.testing.assert_array_equal(np.asarray(xb), np.asarray(x)[rows])
    np.testing.assert_array_equal(
        np.asarray(yb)[..., 0], np.asarray(y)[rows])


def test_streaming_svgd_matches_dense_on_card(gpu):
    """Streaming and dense SVGD transport agree on the card at precision
    "highest" (ragged n: the last column tile is masked)."""
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.normal(size=(3000, 200)), jnp.float32)
    g = jnp.asarray(rng.normal(size=(3000, 200)), jnp.float32)
    with jax.default_matmul_precision("highest"):
        kernel, grad_kernel = svgd_kernel(x)
        dense = (kernel @ (-g) + grad_kernel) / x.shape[0]
        h = median_bandwidth(squared_distance_matrix(x), x.shape[0])
        stream = svgd_phi_streaming(x, g, h, tile=512)
    np.testing.assert_allclose(
        np.asarray(stream), np.asarray(dense), rtol=1e-4, atol=1e-5)
