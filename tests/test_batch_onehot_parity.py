"""The minibatch selector must return exactly the window plain indexing
gives (same keys -> same windows, bit for bit), also under vmap."""

import jax
import jax.numpy as jnp
import numpy as np

import pysgmcmc_tpu.data_batches as db


def test_onehot_matches_dynamic_slice():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(60, 3)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(60,)).astype(np.float32))
    select = db.batch_fn(x, y, batch_size=8)

    for i in range(10):
        key = jax.random.PRNGKey(i)
        start = int(jax.random.randint(key, (), 0, 60 - 8 + 1))
        xb, yb = select(key)
        np.testing.assert_array_equal(np.asarray(xb),
                                      np.asarray(x)[start:start + 8])
        np.testing.assert_array_equal(np.asarray(yb)[:, 0],
                                      np.asarray(y)[start:start + 8])


def test_onehot_under_vmap():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(40, 2)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(40,)).astype(np.float32))
    select = db.batch_fn(x, y, batch_size=5)
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    xb, yb = jax.jit(jax.vmap(select))(keys)
    assert xb.shape == (16, 5, 2)
    assert yb.shape == (16, 5, 1)
    # each batch is a contiguous window of x
    x_np = np.asarray(x)
    for row in np.asarray(xb):
        found = any(
            np.array_equal(row, x_np[s:s + 5]) for s in range(40 - 5 + 1)
        )
        assert found


def test_integer_data_uses_fallback():
    x = jnp.arange(30, dtype=jnp.int32).reshape(30, 1)
    y = jnp.arange(30, dtype=jnp.float32)
    select = db.batch_fn(x, y, batch_size=4)
    xb, yb = select(jax.random.PRNGKey(0))
    assert xb.dtype == jnp.int32
    np.testing.assert_array_equal(
        np.asarray(xb)[:, 0], np.asarray(xb)[0, 0] + np.arange(4)
    )
