"""Stochastic Gradient Langevin Dynamics with scale-adapted burn-in.

JAX redesign of the reference SGLD sampler
(``/root/reference/pysgmcmc/samplers/sgld.py:12-213``): Welling & Teh (ICML
2011) preconditioned by the Springenberg et al. (NIPS 2016) burn-in adaptation
(see :mod:`pysgmcmc_tpu.samplers._adaptive`).

Per-step update (reference ``sgld.py:183-204``, noise constant = 0):

    sigma     = sqrt(2 * eps * minv * A / scale_grad)
    theta_new = theta - eps * minv * A * grad + sigma * N(0, 1)

The whole update is a pure function over a ``SGLDState`` pytree; one sampling
run is a single ``lax.scan`` and multi-chain execution is ``vmap`` over the
state (cf. :mod:`pysgmcmc_tpu.parallel.chains`).

Examples
--------
>>> import jax, jax.numpy as jnp
>>> sampler = SGLDSampler(lambda x: 0.5 * jnp.sum(x**2),
...                       stepsize_schedule=0.05, burn_in_steps=1)
>>> state = sampler.init(jnp.zeros(3))
>>> state, info = sampler.step(state, jax.random.PRNGKey(0))
>>> state.position.shape
(3,)
>>> bool(jnp.isfinite(info.cost))
True
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from pysgmcmc_tpu.samplers._adaptive import AdaptiveStats, init_stats, update_stats
from pysgmcmc_tpu.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu.utils.numeric import safe_divide, safe_sqrt
from pysgmcmc_tpu.utils.pytree import normal_like_tree, tree_cast


class SGLDState(NamedTuple):
    position: Any
    stats: AdaptiveStats
    step: Any
    schedule_state: Any


class SGLDSampler(MCMCSampler):
    """SGLD with self-tuning diagonal preconditioner.

    Parameters (defaults match the reference, ``sgld.py:32-35``):

    - ``stepsize_schedule``: default constant 0.01
    - ``burn_in_steps``: adaptation horizon, default 3000
    - ``A``: friction/step scaling constant, default 1.0
    - ``scale_grad``: gradient/noise scale (usually the dataset size),
      default 1.0
    """

    def __init__(
        self,
        cost_fn,
        stepsize_schedule=0.01,
        burn_in_steps=3000,
        A=1.0,
        scale_grad=1.0,
        dtype=jnp.float32,
        gaussian_prior_scale=0.0,
        noise_bits=None,
    ):
        super().__init__(cost_fn, stepsize_schedule, dtype)
        if burn_in_steps < 0:
            raise ValueError("SGLDSampler: burn_in_steps must be >= 0")
        self.burn_in_steps = int(burn_in_steps)
        self.A = float(A)
        self.scale_grad = float(scale_grad)
        # Analytic Gaussian-prior fold: see SGHMCSampler.gaussian_prior_scale.
        self.gaussian_prior_scale = float(gaussian_prior_scale)
        # Fast RngBitGenerator noise bits: see SGHMCSampler.noise_bits.
        self.noise_bits = noise_bits

    def init(self, params, key=None):
        params = tree_cast(params, self.dtype)
        return SGLDState(
            position=params,
            stats=init_stats(params),
            step=jnp.zeros((), jnp.int32),
            schedule_state=self.stepsize_schedule.init(),
        )

    def partition_frozen(self, state, phase=None):
        """Post-burn-in, the adaptation stats are scan invariants."""
        if phase != "sampling":
            return state, None
        return state._replace(stats=None), state.stats

    @staticmethod
    def merge_frozen(dynamic, frozen):
        if frozen is None:
            return dynamic
        return dynamic._replace(stats=frozen)

    def step(self, state, key, batch=None, noise=None, phase=None):
        """One SGLD step.  ``noise``/``phase`` as in
        :meth:`pysgmcmc_tpu.samplers.sghmc.SGHMCSampler.step`."""
        eps = self._stepsize(state)
        cost, grads = self._cost_and_grad(state.position, batch)
        if self.gaussian_prior_scale:
            scale = jnp.asarray(self.gaussian_prior_scale, self.dtype)
            grads = jax.tree_util.tree_map(
                lambda g, theta: g + scale * theta, grads, state.position
            )

        burning_in = state.step < self.burn_in_steps
        stats, minv = update_stats(state.stats, grads, burning_in, phase)

        if noise is None:
            noise = normal_like_tree(
                key, state.position, bits_impl=self.noise_bits
            )

        def update_leaf(theta, grad, minv_leaf, eta):
            sigma = safe_sqrt(
                2.0 * eps * safe_divide(minv_leaf * self.A, self.scale_grad)
            )
            return theta - eps * minv_leaf * self.A * grad + sigma * eta

        position = jax.tree_util.tree_map(
            update_leaf, state.position, grads, minv, noise
        )

        new_state = SGLDState(
            position=position,
            stats=stats,
            step=state.step + 1,
            schedule_state=self.stepsize_schedule.update(
                state.schedule_state, cost=cost
            ),
        )
        return new_state, SamplerInfo(cost=cost, stepsize=eps)
