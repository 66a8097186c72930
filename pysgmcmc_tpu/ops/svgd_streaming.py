"""Streaming (flash-style) SVGD transport direction.

The SVGD update needs three reductions over the n x n RBF kernel matrix:

    phi_i = (1/n) [ sum_j K_ij * (-grad_j)                (attraction)
                  + (x_i sum_j K_ij - sum_j K_ij x_j)/h^2 ]  (repulsion)

The dense path (:func:`pysgmcmc_tpu.ops.pairwise.svgd_kernel`) materializes
``K`` (and the distance matrix): O(n^2) memory.  Here a ``lax.scan`` walks
the particles in column tiles, builds one ``(n, tile)`` block of ``K`` at a
time and accumulates all three reductions as it goes — the same trick
flash-attention plays on softmax(QK^T)V — so memory is O(n * tile + n * d).

The bandwidth ``h`` is an input (compute it once from
:func:`pysgmcmc_tpu.ops.pairwise.median_bandwidth`, or a subsampled
estimate for very large n).

Examples
--------
>>> import jax, jax.numpy as jnp
>>> x = jax.random.normal(jax.random.PRNGKey(0), (8, 2))
>>> phi = svgd_phi_streaming(x, -x, 1.0, tile=4)
>>> phi.shape
(8, 2)
"""

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("tile",))
def svgd_phi_streaming(particles, cost_grads, h, tile=512):
    """SVGD transport direction phi without materializing the kernel matrix.

    Parameters
    ----------
    particles : (n, d) float32.  Any ``n`` is accepted: it is padded to a
        multiple of ``tile``, and padded columns are masked out of every
        reduction.
    cost_grads : (n, d) float32 — gradients of the COST (negative log
        density); the attraction term uses ``-cost_grads``.
    h : scalar bandwidth.

    Returns phi of shape (n, d); the caller applies the stepsize/Adagrad.
    """
    n, d = particles.shape
    dtype = particles.dtype
    tile = min(tile, n)
    n_tiles = -(-n // tile)
    pad = ((0, n_tiles * tile - n), (0, 0))
    x_cols = jnp.pad(particles, pad).reshape(n_tiles, tile, d)
    g_cols = jnp.pad(cost_grads, pad).reshape(n_tiles, tile, d)
    valid = (jnp.arange(n_tiles * tile) < n).reshape(n_tiles, tile)

    h = jnp.asarray(h, dtype)
    sq_rows = jnp.sum(particles * particles, axis=1)

    def body(acc, cols):
        k_dot_g, k_dot_x, ksum = acc
        x_j, g_j, valid_j = cols
        d2 = (
            sq_rows[:, None]
            + jnp.sum(x_j * x_j, axis=1)[None, :]
            - 2.0 * jnp.dot(particles, x_j.T, preferred_element_type=dtype)
        )
        kernel = jnp.where(
            valid_j[None, :], jnp.exp(-jnp.maximum(d2, 0.0) / (2.0 * h * h)),
            0.0)
        return (
            k_dot_g + jnp.dot(kernel, -g_j, preferred_element_type=dtype),
            k_dot_x + jnp.dot(kernel, x_j, preferred_element_type=dtype),
            ksum + jnp.sum(kernel, axis=1),
        ), None

    zeros = jnp.zeros((n, d), dtype)
    (k_dot_g, k_dot_x, ksum), _ = jax.lax.scan(
        body, (zeros, zeros, jnp.zeros((n,), dtype)),
        (x_cols, g_cols, valid),
    )
    repulsion = (particles * ksum[:, None] - k_dot_x) / (h * h)
    return (k_dot_g + repulsion) / n
