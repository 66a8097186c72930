"""Relativistic Stochastic Gradient Hamiltonian Monte Carlo.

JAX redesign of the reference sampler
(``/root/reference/pysgmcmc/samplers/relativistic_sghmc.py:13-141``), after
Lu et al., "Relativistic Monte Carlo", AISTATS 2017.  Momentum magnitudes are
bounded by the "speed of light" ``c``, making the sampler robust to gradient
scale misspecification.

Per-step update (reference ``relativistic_sghmc.py:120-135``; note the
reference negates the cost so the dynamics see the *log-likelihood* gradient,
``relativistic_sghmc.py:97-103``):

    relativistic velocity:  v(p) = eps * p / (m * sqrt(p^2/(m^2 c^2) + 1))
    noise:                  n = sqrt(eps * (2 D - eps * Bhat)) * N(0, 1)
    momentum:               p_new = p + eps * grad_loglik + n - D * v(p)
    position:               theta_new = theta + v(p_new)

Momentum is initialized from the relativistic marginal with an on-device
rejection sampler (:mod:`pysgmcmc_tpu.ops.relativistic`), replacing the
reference's host-side arspy adaptive rejection sampling
(``relativistic_sghmc.py:143-223``).  Unlike the reference — which draws one
scalar momentum per parameter tensor and therefore only supports scalar
parameters — momenta here are elementwise, so arbitrary pytree parameters
work.

Examples
--------
>>> import jax, jax.numpy as jnp
>>> sampler = RelativisticSGHMCSampler(
...     lambda x: 0.5 * jnp.sum(x**2), stepsize_schedule=0.001)
>>> state = sampler.init(jnp.zeros(2), key=jax.random.PRNGKey(0))
>>> state, info = sampler.step(state, jax.random.PRNGKey(1))
>>> state.momentum.shape
(2,)
>>> bool(jnp.isfinite(state.position).all())
True
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from pysgmcmc_tpu.ops.relativistic import sample_relativistic_momentum_tree
from pysgmcmc_tpu.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu.utils.pytree import normal_like_tree, tree_cast


class RelativisticSGHMCState(NamedTuple):
    position: Any
    momentum: Any
    step: Any
    schedule_state: Any


class RelativisticSGHMCSampler(MCMCSampler):
    """Relativistic SGHMC.

    Parameters (defaults match the reference, ``relativistic_sghmc.py:24-27``):

    - ``stepsize_schedule``: default constant 0.001
    - ``mass``: relativistic mass ``m``, default 1.0
    - ``speed_of_light``: momentum bound ``c``, default 1.0
    - ``D``: diffusion/friction constant, default 1.0
    - ``Bhat``: gradient-noise variance estimate, default 0.0
    """

    def __init__(
        self,
        cost_fn,
        stepsize_schedule=0.001,
        mass=1.0,
        speed_of_light=1.0,
        D=1.0,
        Bhat=0.0,
        dtype=jnp.float32,
        gaussian_prior_scale=0.0,
    ):
        super().__init__(cost_fn, stepsize_schedule, dtype)
        self.mass = float(mass)
        self.speed_of_light = float(speed_of_light)
        self.D = float(D)
        self.Bhat = float(Bhat)
        # analytic isotropic-Gaussian-prior fold, as in SGHMC/SGLD/SGNHT:
        # grad += scale * theta (cost-space) instead of differentiating
        # the prior term — lets the fused kernel path carry the BNN's
        # weight prior without it appearing in cost_fn
        self.gaussian_prior_scale = float(gaussian_prior_scale)

    def _velocity(self, p, eps):
        """eps * p / (m * sqrt(p^2/(m^2 c^2) + 1)) (cf. ``relativistic_sghmc.py:123``)."""
        m, c = self.mass, self.speed_of_light
        return eps * p / (m * jnp.sqrt(p * p / (m**2 * c**2) + 1.0))

    def init(self, params, key=None):
        params = tree_cast(params, self.dtype)
        if key is None:
            key = jax.random.PRNGKey(0)
        momentum = sample_relativistic_momentum_tree(
            key, params, m=self.mass, c=self.speed_of_light
        )
        return RelativisticSGHMCState(
            position=params,
            momentum=momentum,
            step=jnp.zeros((), jnp.int32),
            schedule_state=self.stepsize_schedule.init(),
        )

    def step(self, state, key, batch=None, noise=None, phase=None):
        """One relativistic SGHMC step.  ``phase`` is accepted for driver
        uniformity and ignored (no burn-in adaptation to specialize)."""
        del phase
        eps = self._stepsize(state)
        cost, grads = self._cost_and_grad(state.position, batch)
        if self.gaussian_prior_scale:
            scale = jnp.asarray(self.gaussian_prior_scale, self.dtype)
            grads = jax.tree_util.tree_map(
                lambda g, theta: g + scale * theta, grads, state.position
            )
        # The dynamics use the gradient of the log-likelihood = -cost
        # (cf. relativistic_sghmc.py:97-103).
        loglik_grads = jax.tree_util.tree_map(jnp.negative, grads)

        if noise is None:
            noise = normal_like_tree(key, state.position)
        noise_scale = jnp.sqrt(eps * (2.0 * self.D - eps * self.Bhat))

        def momentum_leaf(p, grad, eta):
            return p + eps * grad + noise_scale * eta - self.D * self._velocity(p, eps)

        momentum = jax.tree_util.tree_map(
            momentum_leaf, state.momentum, loglik_grads, noise
        )
        position = jax.tree_util.tree_map(
            lambda theta, p: theta + self._velocity(p, eps),
            state.position,
            momentum,
        )

        new_state = RelativisticSGHMCState(
            position=position,
            momentum=momentum,
            step=state.step + 1,
            schedule_state=self.stepsize_schedule.update(
                state.schedule_state, cost=cost
            ),
        )
        return new_state, SamplerInfo(cost=cost, stepsize=eps)
