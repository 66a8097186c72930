"""Network architectures for Bayesian neural networks.

The default is the reference's 3x50-tanh heteroscedastic regression net
(``/root/reference/pysgmcmc/models/bayesian_neural_network.py:28-69``):
three 50-unit tanh layers, a linear mean head, and a *learned* log-variance
output bias initialized to ``log(1e-3)`` concatenated as the second output
column.  He-normal (fan-in, truncated normal) weight init, zero biases.

Networks are ``(init_fn, apply_fn)`` pairs over plain dict pytrees — no
framework dependency, so the same params flow through samplers, packed
drivers and ``vmap`` ensembles untouched.  Matmuls pass
``preferred_element_type`` so the accumulation dtype is the network's
``dtype``.

Examples
--------
>>> import jax, jax.numpy as jnp
>>> init, apply = default_network(n_inputs=1)
>>> params = init(jax.random.PRNGKey(0))
>>> out = apply(params, jnp.zeros((5, 1)))
>>> out.shape  # column 0: mean, column 1: log predictive variance
(5, 2)
"""

import jax
import jax.numpy as jnp
import numpy as np


def default_network(n_inputs, units=(50, 50, 50), dtype=jnp.float32):
    """The reference BNN architecture as an ``(init, apply)`` pair.

    ``apply(params, x)`` returns an ``(N, 2)`` array: column 0 the predicted
    mean, column 1 the (input-independent, learned) log predictive variance
    — mirroring ``get_default_net``'s concat output
    (``bayesian_neural_network.py:58-69``).
    """
    he_normal = jax.nn.initializers.variance_scaling(
        1.0, "fan_in", "truncated_normal"
    )
    layer_sizes = [n_inputs, *units, 1]

    def init(key):
        params = {}
        keys = jax.random.split(key, len(layer_sizes) - 1)
        for i, (fan_in, fan_out) in enumerate(
            zip(layer_sizes[:-1], layer_sizes[1:])
        ):
            # f64 draws go through f32, so a float64 network draws the
            # same initial weights as a float32 one (the cast is exact)
            draw_dtype = (
                jnp.float32 if jnp.dtype(dtype).itemsize > 4 else dtype)
            params["w{}".format(i + 1)] = he_normal(
                keys[i], (fan_in, fan_out), draw_dtype
            ).astype(dtype)
            params["b{}".format(i + 1)] = jnp.zeros((fan_out,), dtype)
        params["log_variance_bias"] = jnp.full(
            (1, 1), np.log(1e-3), dtype=dtype
        )
        return params

    n_layers = len(layer_sizes) - 1

    def apply(params, x):
        h = jnp.asarray(x, dtype)
        for i in range(1, n_layers):
            h = jnp.tanh(
                jnp.dot(h, params["w{}".format(i)], preferred_element_type=dtype)
                + params["b{}".format(i)]
            )
        mean = (
            jnp.dot(h, params["w{}".format(n_layers)], preferred_element_type=dtype)
            + params["b{}".format(n_layers)]
        )
        log_var = jnp.broadcast_to(
            params["log_variance_bias"][0, 0], mean.shape
        )
        return jnp.concatenate([mean, log_var], axis=1)

    return init, apply


def dense_network(n_inputs, units=(50, 50, 50), dtype=jnp.float32):
    """The same architecture with squeezed parameter shapes.

    Mathematically identical to :func:`default_network` — same function
    class, and ``init`` draws the *same* weights from the same key (the
    He-normal matrices are sampled at the reference shapes, then stored
    squeezed) — but the input layer and head avoid matmul operands whose
    minor dimension is 1:

    - a 1-input first layer is an outer product, so ``w1`` is stored
      ``(units[0],)`` and applied as a broadcast multiply
    - the mean head is a matvec, so the last weight is stored
      ``(units[-1],)``

    Whether this layout is faster than :func:`default_network` on a GPU
    is not measured.

    Examples
    --------
    >>> import jax, jax.numpy as jnp
    >>> init, apply = dense_network(n_inputs=1)
    >>> params = init(jax.random.PRNGKey(0))
    >>> params["w1"].shape, params["w4"].shape
    ((50,), (50,))
    >>> ref_init, ref_apply = default_network(n_inputs=1)
    >>> x = jnp.linspace(0, 1, 5).reshape(5, 1)
    >>> out = apply(params, x)
    >>> ref = ref_apply(ref_init(jax.random.PRNGKey(0)), x)
    >>> bool(jnp.allclose(out, ref, atol=1e-6))
    True
    """
    ref_init, _ = default_network(n_inputs, units, dtype)
    n_layers = len(units) + 1
    first_key = "w1"
    last_key = "w{}".format(n_layers)
    squeeze_first = n_inputs == 1

    def init(key):
        params = ref_init(key)
        if squeeze_first:
            params[first_key] = params[first_key][0]
        params[last_key] = params[last_key][:, 0]
        return params

    def apply(params, x):
        h = jnp.asarray(x, dtype)
        w1 = params[first_key]
        if squeeze_first:
            h = jnp.tanh(h * w1[None, :] + params["b1"])
        else:
            h = jnp.tanh(
                jnp.dot(h, w1, preferred_element_type=dtype) + params["b1"]
            )
        for i in range(2, n_layers):
            h = jnp.tanh(
                jnp.dot(h, params["w{}".format(i)], preferred_element_type=dtype)
                + params["b{}".format(i)]
            )
        mean = (
            jnp.dot(h, params[last_key], preferred_element_type=dtype)
            + params["b{}".format(n_layers)][0]
        )
        log_var = jnp.broadcast_to(
            params["log_variance_bias"][0, 0], mean.shape
        )
        return jnp.stack([mean, log_var], axis=1)

    return init, apply
