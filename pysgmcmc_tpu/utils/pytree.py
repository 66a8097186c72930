"""Pytree helpers shared by all samplers.

The reference flattens every parameter into an ``(n, 1)`` column vector and
reshapes it back on every step (``vectorize``/``unvectorize``,
``/root/reference/pysgmcmc/tensor_utils.py:17-153``).  With JAX pytrees the
whole dance disappears: samplers update each leaf in place via ``tree_map``
and only the packed drivers ravel (once, at trace time).

Examples
--------
>>> import jax, jax.numpy as jnp
>>> tree = {"b": jnp.zeros(3), "w": jnp.zeros((2, 3))}
>>> tree_size(tree)
9
>>> eta = normal_like_tree(jax.random.PRNGKey(0), tree)
>>> eta["w"].shape
(2, 3)
"""

import jax
import jax.numpy as jnp


def tree_size(tree):
    """Total number of scalar elements across all leaves."""
    return sum(leaf.size for leaf in jax.tree_util.tree_leaves(tree))


def tree_zeros_like(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda leaf: jnp.zeros_like(leaf, dtype=dtype or leaf.dtype), tree
    )


def tree_ones_like(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda leaf: jnp.ones_like(leaf, dtype=dtype or leaf.dtype), tree
    )


def tree_cast(tree, dtype):
    return jax.tree_util.tree_map(lambda leaf: jnp.asarray(leaf, dtype=dtype), tree)


def normal_like_tree(key, tree, bits_impl=None):
    """Draw a standard-normal sample for every leaf of ``tree``.

    One fold of the key per leaf keeps draws independent across leaves while
    staying deterministic in the leaf ordering of the pytree.  This replaces
    the reference's per-op seeded ``tf.random_normal``
    (``samplers/base_classes.py:199-220``) with explicit threefry keys, which
    is what makes chains bit-reproducible under ``vmap``/``pjit``.

    ``bits_impl="rbg"`` keeps the (high-quality) threefry key derivation but
    reinterprets each per-leaf key as an ``rbg`` key for the draw itself, so
    the random *bits* come from the XLA ``RngBitGenerator``, with the same
    stream independence (streams are still separated by threefry splits).
    Whether it is faster on a GPU is not measured.  Draws
    are deterministic in (key, shape, impl) but differ bitwise from the
    default threefry draws.
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    if bits_impl is not None:
        def rekey(k):
            data = jax.random.key_data(k).reshape(-1)
            need = jax.random.key_data(
                jax.random.key(0, impl=bits_impl)
            ).size
            reps = -(-need // data.size)
            data = jnp.tile(data, reps)[:need]
            return jax.random.wrap_key_data(data, impl=bits_impl)

        keys = [rekey(keys[i]) for i in range(len(leaves))]
    samples = [
        jax.random.normal(k, leaf.shape, dtype=leaf.dtype)
        for k, leaf in zip(keys, leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, samples)
