"""Stochastic Gradient Hamiltonian Monte Carlo with scale-adapted burn-in.

JAX redesign of the reference SGHMC sampler
(``/root/reference/pysgmcmc/samplers/sghmc.py:12-253``): Chen, Fox & Guestrin
(ICML 2014) with the Springenberg et al. (NIPS 2016) self-tuning burn-in
(see :mod:`pysgmcmc_tpu.samplers._adaptive`).

Per-step update (reference ``sghmc.py:109-253``; ``noise`` constant = 0):

    eps_scaled  = eps / sqrt(scale_grad)                         (sghmc.py:115)
    noise_var   = 2 * eps_scaled**2 * mdecay * minv
                  - 2 * eps_scaled**3 * minv**2 * noise
                  - eps_scaled**4                                (sghmc.py:211-217)
    sigma       = sqrt(max(noise_var, 1e-16))                    (sghmc.py:220)
    v_new       = v - eps**2 * minv * grad - mdecay * v
                  + sigma * N(0, 1)                              (sghmc.py:233-238)
    theta_new   = theta + v_new                                  (sghmc.py:241-243)

Note the reference's asymmetry — the gradient term uses the *unscaled*
stepsize squared while the noise uses ``eps_scaled`` — is preserved.

Where the reference chains `tf.assign` ops under control dependencies and
pays a ``session.run`` per step, this step is one pure function XLA fuses
into a handful of elementwise kernels; :mod:`pysgmcmc_tpu.parallel.packed`
applies the same math to packed multi-chain state.

Examples
--------
>>> import jax, jax.numpy as jnp
>>> sampler = SGHMCSampler(lambda x: 0.5 * jnp.sum(x**2),
...                        stepsize_schedule=0.1, burn_in_steps=2)
>>> state = sampler.init(jnp.asarray([1.0]))
>>> state, info = sampler.step(state, jax.random.PRNGKey(0))
>>> (int(state.step), round(float(info.stepsize), 3))
(1, 0.1)
>>> state.momentum.shape
(1,)
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from pysgmcmc_tpu.samplers._adaptive import AdaptiveStats, init_stats, update_stats
from pysgmcmc_tpu.samplers.base import MCMCSampler, SamplerInfo
from pysgmcmc_tpu.utils.pytree import normal_like_tree, tree_cast, tree_zeros_like


class SGHMCState(NamedTuple):
    position: Any
    momentum: Any
    stats: AdaptiveStats
    step: Any
    schedule_state: Any


class SGHMCSampler(MCMCSampler):
    """SGHMC with self-tuning diagonal mass matrix.

    Parameters (defaults match the reference, ``sghmc.py:31-34``):

    - ``stepsize_schedule``: default constant 0.01
    - ``burn_in_steps``: adaptation horizon, default 3000
    - ``mdecay``: momentum decay per step, default 0.05
    - ``scale_grad``: gradient/noise scale (usually the dataset size),
      default 1.0
    """

    def __init__(
        self,
        cost_fn,
        stepsize_schedule=0.01,
        burn_in_steps=3000,
        mdecay=0.05,
        scale_grad=1.0,
        dtype=jnp.float32,
        gaussian_prior_scale=0.0,
        noise_bits=None,
    ):
        super().__init__(cost_fn, stepsize_schedule, dtype)
        if burn_in_steps < 0:
            raise ValueError("SGHMCSampler: burn_in_steps must be >= 0")
        self.burn_in_steps = int(burn_in_steps)
        self.mdecay = float(mdecay)
        self.scale_grad = float(scale_grad)
        # noise_bits="rbg": generate the injected noise's random bits with
        # the XLA RngBitGenerator instead of threefry (stream separation
        # still threefry) — see
        # :func:`pysgmcmc_tpu.utils.pytree.normal_like_tree`.
        self.noise_bits = noise_bits
        # With gaussian_prior_scale = s > 0 the update uses the analytic
        # gradient of an isotropic Gaussian prior, grad += s * theta,
        # instead of differentiating a quadratic prior term inside cost_fn.
        # Mathematically identical dynamics, but the term fuses into the
        # (theta-reading) update kernel instead of costing an extra
        # autodiff pass over every parameter (~14% of the flagship step).
        self.gaussian_prior_scale = float(gaussian_prior_scale)

    def init(self, params, key=None):
        params = tree_cast(params, self.dtype)
        return SGHMCState(
            position=params,
            momentum=tree_zeros_like(params),
            stats=init_stats(params),
            step=jnp.zeros((), jnp.int32),
            schedule_state=self.stepsize_schedule.init(),
        )

    def partition_frozen(self, state, phase=None):
        """Post-burn-in, the adaptation stats (incl. the frozen mass-matrix
        inverse) are scan invariants — hoist them out of the carry."""
        if phase != "sampling":
            return state, None
        return state._replace(stats=None), state.stats

    @staticmethod
    def merge_frozen(dynamic, frozen):
        if frozen is None:
            return dynamic
        return dynamic._replace(stats=frozen)

    def step(self, state, key, batch=None, noise=None, phase=None):
        """One SGHMC step.

        ``noise`` optionally injects the standard-normal draw (a pytree
        shaped like the position) instead of drawing from ``key`` — used by
        parity tests to compare bitwise against the packed update rules
        (:func:`pysgmcmc_tpu.parallel.packed.sghmc_update`, which takes the
        same draw as ``eta``).

        ``phase`` statically specializes the step to one side of the
        burn-in boundary (``"burn_in"`` / ``"sampling"``); ``None`` keeps
        the dynamic step-counter branch.  See
        :func:`pysgmcmc_tpu.samplers._adaptive.update_stats` — positions
        are bitwise identical, the sampling phase just stops carrying the
        (frozen) adaptation statistics through HBM every step.
        """
        eps = self._stepsize(state)
        eps_scaled = eps / jnp.sqrt(jnp.asarray(self.scale_grad, self.dtype))
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

        def momentum_leaf(v, grad, minv_leaf, eta):
            noise_var = (
                2.0 * eps_scaled**2 * self.mdecay * minv_leaf - eps_scaled**4
            )
            sigma = jnp.sqrt(jnp.maximum(noise_var, 1e-16))
            return v - eps**2 * minv_leaf * grad - self.mdecay * v + sigma * eta

        momentum = jax.tree_util.tree_map(
            momentum_leaf, state.momentum, grads, minv, noise
        )
        position = jax.tree_util.tree_map(
            lambda theta, v: theta + v, state.position, momentum
        )

        new_state = SGHMCState(
            position=position,
            momentum=momentum,
            stats=stats,
            step=state.step + 1,
            schedule_state=self.stepsize_schedule.update(
                state.schedule_state, cost=cost
            ),
        )
        return new_state, SamplerInfo(cost=cost, stepsize=eps)
