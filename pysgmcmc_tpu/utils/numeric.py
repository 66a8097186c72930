"""Numerically-safe elementwise helpers.

JAX counterparts of the reference's guard-rail ops
(``/root/reference/pysgmcmc/tensor_utils.py:211-323``): sign-aware safe
division and clipped square root.  These are pure ``jnp`` functions that XLA
fuses into surrounding elementwise chains, so they carry no runtime cost over
raw ``/`` and ``sqrt``.

The reference also ships ``pdist``/``squareform``/``median`` helpers built
from TF graph ops (``tensor_utils.py:160-576``).  Here ``median`` is a single
sort on device; pairwise distances live in ``pysgmcmc_tpu.ops.pairwise`` as a
matmul-based implementation with a streaming variant for large ensembles.
"""

import jax.numpy as jnp


def safe_divide(x, y, small_constant=1e-16):
    """Divide ``x / y``, nudging ``y`` away from zero in a sign-aware way.

    Mirrors the reference semantics (``tensor_utils.py:269``):
    ``x / (y + 2 * sign(y) * c + c)``.  For ``y == 0`` the denominator
    becomes ``c``; for ``y == -c`` it becomes ``-2c`` (instead of the
    catastrophic ``0`` naive ``y + c`` would give).

    Examples
    --------
    >>> import jax.numpy as jnp
    >>> bool(jnp.isfinite(safe_divide(1.0, 0.0)))
    True
    >>> bool(jnp.isfinite(safe_divide(1.0, -1e-16)))
    True
    """
    c = jnp.asarray(small_constant, dtype=jnp.result_type(y))
    return x / (y + 2.0 * jnp.sign(y) * c + c)


def safe_sqrt(x, clip_value_min=0.0, clip_value_max=float("inf")):
    """``sqrt(clip(x, min, max))`` — avoids NaNs from tiny negative inputs.

    Mirrors ``tensor_utils.py:272-323``.

    Examples
    --------
    >>> import jax.numpy as jnp
    >>> float(safe_sqrt(-1e-16))
    0.0
    """
    return jnp.sqrt(jnp.clip(x, clip_value_min, clip_value_max))


def median(x):
    """Median over all elements of ``x``.

    The reference builds this from a full ``top_k`` sort in graph mode
    (``tensor_utils.py:160-208``); here it is one device-side sort.
    Matches ``numpy.median`` (averages the two central elements for even
    sizes).

    Examples
    --------
    >>> import jax.numpy as jnp
    >>> float(median(jnp.asarray([3.0, 1.0, 2.0])))
    2.0
    >>> float(median(jnp.asarray([4.0, 1.0, 2.0, 3.0])))
    2.5
    """
    flat = jnp.ravel(x)
    sorted_vals = jnp.sort(flat)
    n = flat.shape[0]
    mid = n // 2
    if n % 2 == 1:
        return sorted_vals[mid]
    return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])
