"""Sampling the relativistic-momentum marginal, on device.

The relativistic momentum in Relativistic SGHMC (Lu et al., AISTATS 2017) has
marginal density

    p(p) ∝ exp(-m c^2 sqrt(p^2 / (m^2 c^2) + 1)) = exp(-c sqrt(p^2 + m^2 c^2))

a symmetric hyperbolic distribution.  The reference draws initial momenta via
the external ``arspy`` adaptive-rejection-sampling package on the host
(``/root/reference/pysgmcmc/samplers/relativistic_sghmc.py:143-223``), which
is CPU-only and non-jittable.  Here we exploit log-concavity directly with a
tight analytic envelope, giving a vectorized, jittable, key-deterministic
rejection sampler that runs on the device.

By Cauchy-Schwarz, for any tilt ``beta in [0, 1)``:

    sqrt(p^2 + (mc)^2) >= beta * mc + sqrt(1 - beta^2) * |p|

so a Laplace proposal with rate ``r = c sqrt(1 - beta^2)`` dominates the
target with acceptance ``exp(-c sqrt(p^2+(mc)^2) + c beta mc + r |p|)``.
Choosing the optimal tilt — the root of ``beta / (1 - beta^2) = m c^2`` —
keeps the acceptance rate O(1) for *any* mass and speed of light (for
m = c = 1 it is ~0.7 per round; a naive untilted Laplace envelope decays
like ``exp(-m c^2)``).  The ``while_loop`` redraws only unaccepted slots.

Examples
--------
>>> import jax
>>> p = sample_relativistic_momentum(jax.random.PRNGKey(0), (500,))
>>> p.shape
(500,)
>>> bool(abs(float(p.mean())) < 0.2)  # symmetric marginal
True
"""

import jax
import jax.numpy as jnp


def _optimal_tilt(lam):
    """Root of ``beta / (1 - beta^2) = lam`` in [0, 1): the acceptance-rate
    maximizing tilt for target curvature ``lam = m c^2``."""
    return (-1.0 + jnp.sqrt(1.0 + 4.0 * lam**2)) / (2.0 * lam)


def sample_relativistic_momentum(key, shape, m=1.0, c=1.0, dtype=jnp.float32):
    """Draw ``shape`` i.i.d. samples of the relativistic momentum marginal.

    Exact rejection sampling from an optimally tilted Laplace envelope;
    deterministic given ``key``.  Unlike the reference (one scalar momentum
    per parameter *tensor*, ``relativistic_sghmc.py:108-113``), this samples
    elementwise, which is what the underlying relativistic dynamics require
    for non-scalar parameters.
    """
    m = jnp.asarray(m, dtype)
    c = jnp.asarray(c, dtype)
    b = m * c  # momentum scale
    beta = _optimal_tilt(m * c**2)
    rate = c * jnp.sqrt(1.0 - beta**2)

    def propose(key):
        key_lap, key_u = jax.random.split(key)
        proposal = jax.random.laplace(key_lap, shape, dtype=dtype) / rate
        log_accept = (
            -c * jnp.sqrt(proposal**2 + b**2)
            + c * beta * b
            + rate * jnp.abs(proposal)
        )
        u = jax.random.uniform(key_u, shape, dtype=dtype)
        return proposal, jnp.log(u) < log_accept

    def cond(carry):
        _, accepted, _ = carry
        return ~jnp.all(accepted)

    def body(carry):
        samples, accepted, key = carry
        key, subkey = jax.random.split(key)
        proposal, accept = propose(subkey)
        samples = jnp.where(accepted, samples, proposal)
        return samples, accepted | accept, key

    key, subkey = jax.random.split(key)
    samples, accepted = propose(subkey)
    samples, _, _ = jax.lax.while_loop(
        cond, body, (samples, accepted, key)
    )
    return samples


def sample_relativistic_momentum_tree(key, tree, m=1.0, c=1.0):
    """Relativistic-momentum sample with the shape/dtype structure of ``tree``."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    samples = [
        sample_relativistic_momentum(k, leaf.shape, m=m, c=c, dtype=leaf.dtype)
        for k, leaf in zip(keys, leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, samples)


def relativistic_kinetic_energy(p, m=1.0, c=1.0):
    """K(p) = m c^2 sqrt(p^2/(m^2 c^2) + 1) (cf. ``relativistic_sghmc.py:208-216``)."""
    return m * c**2 * jnp.sqrt(p**2 / (m**2 * c**2) + 1.0)
