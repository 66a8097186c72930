"""Pairwise distances and the SVGD RBF kernel, as one Gram matmul.

The reference computes pairwise particle distances with an O(n^2) *Python
loop* of graph ops plus a `dynamic_stitch` squareform and a full-sort median
(``/root/reference/pysgmcmc/tensor_utils.py:326-576``), which caps SVGD
ensembles at a few dozen particles.  Here the Gram matrix is one matmul:

    D_ij = |x_i|^2 + |x_j|^2 - 2 <x_i, x_j>

one ``(n, d) @ (d, n)`` matmul plus rank-1 broadcasts, so thousands of
particles are cheap.  The median-heuristic bandwidth is one device-side sort.

``pdist``/``squareform`` equivalents are provided for API parity with the
reference's tensor_utils.

Examples
--------
>>> import jax.numpy as jnp
>>> x = jnp.asarray([[0.0], [3.0], [4.0]])
>>> [round(float(v), 1) for v in pdist(x)]  # pairs (0,1), (0,2), (1,2)
[3.0, 4.0, 1.0]
>>> squareform(pdist(x)).shape
(3, 3)
>>> float(squareform(pdist(x))[0, 2])
4.0
"""

import jax.numpy as jnp

from pysgmcmc_tpu.utils.numeric import median


def squared_distance_matrix(x):
    """All-pairs squared euclidean distances of rows of ``x`` — one matmul.

    Clamped at zero: the Gram-expansion can go slightly negative in floating
    point for near-identical rows.
    """
    sq_norms = jnp.sum(x * x, axis=-1)
    gram = jnp.dot(x, x.T, preferred_element_type=x.dtype)
    d2 = sq_norms[:, None] + sq_norms[None, :] - 2.0 * gram
    return jnp.maximum(d2, 0.0)


def pdist(x):
    """Condensed pairwise euclidean distances (upper triangle, row-major).

    Parity helper for ``tensor_utils.pdist`` (``tensor_utils.py:326-419``),
    matching ``scipy.spatial.distance.pdist`` ordering.  Uses the exact
    broadcast-difference formulation (O(n^2 d) memory) rather than the Gram
    expansion: this path exists for numerical parity with scipy, while
    :func:`squared_distance_matrix` is the matmul fast path for SVGD.
    """
    n = x.shape[0]
    diff = x[:, None, :] - x[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    rows, cols = jnp.triu_indices(n, k=1)
    return jnp.sqrt(d2[rows, cols])


def squareform(condensed, n=None):
    """Condensed distance vector -> symmetric square matrix.

    Parity helper for ``tensor_utils.squareform`` (``tensor_utils.py:422-576``).
    """
    if n is None:
        # solve n(n-1)/2 = len(condensed)
        import math

        n = int(round((1 + math.isqrt(1 + 8 * condensed.shape[0])) / 2))
    out = jnp.zeros((n, n), dtype=condensed.dtype)
    rows, cols = jnp.triu_indices(n, k=1)
    out = out.at[rows, cols].set(condensed)
    return out + out.T


def median_bandwidth(d2, n_particles):
    """Median-heuristic RBF bandwidth (cf. ``samplers/svgd.py:168-170``):

    ``h = sqrt(0.5 * median(D^2) / log(n + 1))``
    """
    return jnp.sqrt(
        0.5 * median(d2) / jnp.log(jnp.asarray(n_particles, d2.dtype) + 1.0)
    )


def svgd_kernel(particles):
    """RBF kernel matrix and its summed gradients for SVGD.

    For ``K_ij = exp(-D_ij / (2 h^2))`` returns ``(K, dK)`` with

        dK_i = sum_j grad_{x_j} K(x_j, x_i)
             = (x_i * sum_j K_ij - sum_j K_ij x_j) / h^2

    matching the reference's ``svgd_kernel`` (``samplers/svgd.py:146-180``)
    but computed from a single Gram matrix instead of looped graph ops.
    """
    n = particles.shape[0]
    d2 = squared_distance_matrix(particles)
    h = median_bandwidth(d2, n)
    kernel = jnp.exp(-d2 / (2.0 * h**2))
    kernel_sum = jnp.sum(kernel, axis=1)
    grad_kernel = (
        particles * kernel_sum[:, None]
        - jnp.dot(kernel, particles, preferred_element_type=particles.dtype)
    ) / h**2
    return kernel, grad_kernel
