"""SGHMC over stacked flat chains.

Sampler state lives as six ``(n_chains, dim)`` float32 arrays, gradients
come from one vmapped autodiff pass, and the entire update (burn-in EMAs,
noise, momentum, position) is one elementwise pass over the flat arrays,
which XLA fuses.

Equivalent math to :class:`pysgmcmc_tpu.samplers.sghmc.SGHMCSampler`
(reference semantics ``/root/reference/pysgmcmc/samplers/sghmc.py:109-253``);
the pytree sampler remains the reference implementation and the parity
tests pin this path against it.

Examples
--------
>>> import jax.numpy as jnp
>>> fused = FusedSGHMC(lambda p: jnp.sum(p["x"] ** 2), {"x": jnp.zeros(2)})
>>> state = fused.init({"x": jnp.zeros((4, 2))})
>>> state.theta.shape  # 4 chains, 2 parameters each
(4, 2)
>>> back = fused.unflatten_positions(state.theta)
>>> back["x"].shape
(4, 2)
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


def update_math(theta, v, tau, g, v_hat, minv, grad, eta,
                eps, eps_scaled, mdecay, burning_in):
    """The SGHMC step, identical term-by-term to samplers/sghmc.py."""
    small = 1e-16
    r = 1.0 / (tau + 1.0)
    sqrt_vhat = jnp.sqrt(jnp.maximum(v_hat, 0.0))
    minv_new = 1.0 / (sqrt_vhat + 2.0 * jnp.sign(sqrt_vhat) * small + small)
    minv_used = jnp.where(burning_in, minv_new, minv)

    denom = v_hat + 2.0 * jnp.sign(v_hat) * small + small
    tau_new = tau + (-g * g * tau) / denom + 1.0
    g_new = g - r * g + r * grad
    v_hat_new = v_hat - r * v_hat + r * grad * grad

    noise_var = 2.0 * eps_scaled**2 * mdecay * minv_used - eps_scaled**4
    sigma = jnp.sqrt(jnp.maximum(noise_var, 1e-16))
    v_new = v - eps**2 * minv_used * grad - mdecay * v + sigma * eta
    theta_new = theta + v_new
    return theta_new, v_new, tau_new, g_new, v_hat_new, minv_used


class FusedSGHMCState(NamedTuple):
    theta: Any  # (n_chains, dim)
    momentum: Any
    tau: Any
    g: Any
    v_hat: Any
    minv: Any
    step: Any  # scalar int32


class FusedSGHMC:
    """Stacked-chain SGHMC with the update fused over flat state.

    Parameters mirror :class:`~pysgmcmc_tpu.samplers.sghmc.SGHMCSampler`;
    ``template_params`` fixes the parameter pytree structure that
    ``cost_fn`` expects for a single chain.
    """

    def __init__(
        self,
        cost_fn,
        template_params,
        stepsize=0.01,
        burn_in_steps=3000,
        mdecay=0.05,
        scale_grad=1.0,
        compute_dtype=None,
    ):
        flat, unravel = ravel_pytree(template_params)
        self.dim = int(flat.size)
        self.unravel = unravel
        self.cost_fn = cost_fn
        self.stepsize = float(stepsize)
        self.burn_in_steps = int(burn_in_steps)
        self.mdecay = float(mdecay)
        self.scale_grad = float(scale_grad)
        # Run the cost function's network in this dtype; gradients land
        # back in f32 via the cast's transpose.
        self.compute_dtype = compute_dtype

    #  State ------------------------------------------------------------------

    def flatten_positions(self, stacked_params):
        """(n_chains, ...) pytree -> (n_chains, dim) float32."""
        theta = jax.vmap(lambda p: ravel_pytree(p)[0])(stacked_params)
        return jnp.asarray(theta, jnp.float32)

    def unflatten_positions(self, theta):
        """(n_chains, dim) -> (n_chains, ...) pytree."""
        return jax.vmap(self.unravel)(theta)

    def init(self, stacked_params):
        theta = self.flatten_positions(stacked_params)
        ones = jnp.ones_like(theta)
        return FusedSGHMCState(
            theta=theta,
            momentum=jnp.zeros_like(theta),
            tau=ones,
            g=ones,
            v_hat=ones,
            minv=ones,
            step=jnp.zeros((), jnp.int32),
        )

    #  Stepping ----------------------------------------------------------------

    def _grads(self, theta, batch):
        def maybe_cast(params):
            if self.compute_dtype is None:
                return params
            return jax.tree_util.tree_map(
                lambda leaf: leaf.astype(self.compute_dtype), params
            )

        def flat_cost(row, batch):
            return self.cost_fn(maybe_cast(self.unravel(row)), batch)

        if batch is None:
            costs, grads = jax.vmap(
                jax.value_and_grad(lambda row: self.cost_fn(
                    maybe_cast(self.unravel(row))
                ))
            )(theta)
        else:
            costs, grads = jax.vmap(
                jax.value_and_grad(flat_cost), in_axes=(0, 0)
            )(theta, batch)
        return costs, grads

    def step(self, state, batch=None, key=None, noise=None):
        """Advance all chains one step.  ``batch`` has a leading chain axis.

        The injected noise is drawn from ``key``; ``noise`` optionally
        injects the standard-normal draw (shaped like ``state.theta``)
        instead.
        """
        if key is None and noise is None:
            raise ValueError("FusedSGHMC.step needs a key (or noise)")
        costs, grads = self._grads(state.theta, batch)
        burning_in = state.step < self.burn_in_steps
        if noise is None:
            noise = jax.random.normal(key, state.theta.shape, state.theta.dtype)
        eps = jnp.asarray(self.stepsize, jnp.float32)
        eps_scaled = eps / jnp.sqrt(jnp.asarray(self.scale_grad, jnp.float32))
        theta, v, tau, g, v_hat, minv = update_math(
            state.theta, state.momentum, state.tau, state.g,
            state.v_hat, state.minv, grads, noise,
            eps, eps_scaled, jnp.asarray(self.mdecay, jnp.float32),
            burning_in,
        )
        return (
            FusedSGHMCState(theta, v, tau, g, v_hat, minv, state.step + 1),
            costs,
        )

    def run(self, state, key, n_steps, batch_fn=None, per_chain_batches=True):
        """Scan ``n_steps`` fused steps; returns ``(state, final_costs)``.

        ``batch_fn`` is the pure ``(key) -> batch`` selector from
        :mod:`pysgmcmc_tpu.data_batches`; with ``per_chain_batches`` each
        chain draws its own minibatch (matching the semantics of independent
        per-chain training runs).
        """
        n_chains = state.theta.shape[0]

        def one_step(carry, _):
            state, key = carry
            key, key_batch, key_noise = jax.random.split(key, 3)
            if batch_fn is None:
                batch = None
            elif per_chain_batches:
                batch = jax.vmap(batch_fn)(jax.random.split(key_batch, n_chains))
            else:
                single = batch_fn(key_batch)
                batch = jax.tree_util.tree_map(
                    lambda leaf: jnp.broadcast_to(
                        leaf[None], (n_chains,) + leaf.shape
                    ),
                    single,
                )
            state, costs = self.step(state, batch, key=key_noise)
            return (state, key), costs

        (state, _), costs = jax.lax.scan(
            one_step, (state, key), None, length=n_steps
        )
        return state, costs[-1]
