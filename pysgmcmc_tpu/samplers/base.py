"""Functional sampler contract and chain drivers.

The reference's samplers build a TF graph in ``__init__`` and execute one
``session.run`` per ``next(sampler)`` — a full host<->device round trip every
step (``/root/reference/pysgmcmc/samplers/base_classes.py:258-310``).  Here a
sampler is a pair of pure functions over an explicit state pytree:

    state          = sampler.init(params, key)
    state, info    = sampler.step(state, key, batch)

and an entire run is ONE ``lax.scan`` under ``jit`` (:func:`sample_chain`),
so the hot loop never leaves XLA.  Thousands of independent chains are a
``vmap`` over ``init``/``step`` (see :mod:`pysgmcmc_tpu.parallel.chains`),
sharded over a device mesh.

The burn-in machinery of the reference (``BurnInMCMCSampler``,
``base_classes.py:313-456``) — Python-side ``is_burning_in`` branching plus a
feed-dict that freezes the tuned mass-matrix inverse — collapses into a
``jnp.where`` on ``state.step`` inside the jitted step (see
:mod:`pysgmcmc_tpu.samplers._adaptive`).

For users of the reference API, :class:`IterativeSampler` preserves the
iterator protocol: ``sample, cost = next(sampler)``.

Examples
--------
Functional contract plus the reference's iterator facade:

>>> import jax, jax.numpy as jnp
>>> from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler
>>> sampler = SGHMCSampler(lambda x: 0.5 * jnp.sum(x**2),
...                        stepsize_schedule=0.05, burn_in_steps=2)
>>> state = sampler.init(jnp.zeros(2))
>>> state, positions, costs = sample_chain(
...     sampler, state, jax.random.PRNGKey(0), 5)
>>> (positions.shape, costs.shape)
((5, 2), (5,))
>>> list_sampler = SGHMCSampler(  # reference-style list-of-params cost
...     lambda params: 0.5 * jnp.sum(params[0] ** 2), stepsize_schedule=0.05)
>>> it = IterativeSampler(list_sampler, [jnp.zeros(2)], key=0)
>>> sample, cost = next(it)  # single-param list unravels to a bare array
>>> sample.shape
(2,)
"""

import itertools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from pysgmcmc_tpu.stepsize_schedules import ConstantStepsizeSchedule, StepsizeSchedule


class SamplerInfo(NamedTuple):
    """Per-step auxiliary outputs (cost value and the stepsize used)."""

    cost: Any
    stepsize: Any


class MCMCSampler:
    """Base class for functional SG-MCMC samplers.

    Parameters
    ----------
    cost_fn : callable
        ``cost_fn(params)`` or ``cost_fn(params, batch)`` returning a scalar
        cost (negative log likelihood, ``U`` in the literature).  Gradients
        are taken with JAX autodiff — the replacement for
        ``tf.gradients`` in the reference (``samplers/sghmc.py:121-122``).
    stepsize_schedule : StepsizeSchedule or float
        Stepsize schedule evaluated in-graph each step.  A bare float is
        promoted to a :class:`ConstantStepsizeSchedule`.
    dtype : jnp dtype
        Element type for sampler state.  The reference defaults to float64
        (``sghmc.py:34``); here float32 is the default, and float64
        is available under ``jax.config.update("jax_enable_x64", True)``.
    """

    def __init__(self, cost_fn, stepsize_schedule=0.01, dtype=jnp.float32):
        if not callable(cost_fn):
            raise ValueError(
                "MCMCSampler: `cost_fn` must be callable, got {!r}".format(cost_fn)
            )
        if not isinstance(stepsize_schedule, StepsizeSchedule):
            stepsize_schedule = ConstantStepsizeSchedule(float(stepsize_schedule))
        self.cost_fn = cost_fn
        self.stepsize_schedule = stepsize_schedule
        self.dtype = dtype

    # -- contract -----------------------------------------------------------
    def init(self, params, key=None):
        raise NotImplementedError

    def step(self, state, key, batch=None, phase=None):
        raise NotImplementedError

    def partition_frozen(self, state, phase=None):
        """Split ``state`` into ``(dynamic, frozen)`` for a phased scan.

        ``frozen`` is the part of the state that ``step`` will provably not
        modify during ``phase`` (e.g. the adaptation statistics after
        burn-in).  :func:`sample_chain` closes over ``frozen`` so XLA treats
        it as a loop invariant instead of copying it through the scan carry
        every step — measured ~8% of the flagship step.  The default keeps
        everything dynamic.
        """
        del phase
        return state, None

    @staticmethod
    def merge_frozen(dynamic, frozen):
        """Inverse of :meth:`partition_frozen`."""
        del frozen
        return dynamic

    @staticmethod
    def position(state):
        """Extract the current sample (the target parameters) from a state."""
        return state.position

    # -- shared helpers ------------------------------------------------------
    def _cost_and_grad(self, params, batch):
        """Evaluate cost and its gradient, with or without a minibatch."""
        if batch is None:
            return jax.value_and_grad(self.cost_fn)(params)
        return jax.value_and_grad(self.cost_fn)(params, batch)

    def _stepsize(self, state):
        eps = self.stepsize_schedule.value(state.schedule_state, state.step)
        return jnp.asarray(eps, dtype=self.dtype)


def sample_chain(
    sampler,
    state,
    key,
    n_samples,
    batch_fn=None,
    keep_every=1,
    collect_costs=True,
    phase=None,
):
    """Run ``n_samples * keep_every`` sampler steps as one ``lax.scan``.

    Returns ``(final_state, positions, costs)`` where ``positions`` is the
    sampler position pytree with a stacked leading axis of length
    ``n_samples`` (only every ``keep_every``-th step is kept — thinning is
    performed *inside* the scan with a nested scan, so unkept iterates are
    never materialized in HBM).

    This is the on-device replacement for the reference's
    ``islice(sampler, n)`` extraction loop
    (``diagnostics/sample_chains.py:166-169``): one compiled program instead
    of one ``session.run`` per sample.

    Parameters
    ----------
    batch_fn : callable, optional
        Pure ``(key) -> batch`` minibatch selector (see
        :mod:`pysgmcmc_tpu.data_batches`).  ``None`` means the cost function
        needs no minibatch.
    phase : str, optional
        Statically specialize every step of this scan to one side of a
        burn-in sampler's adaptation boundary: ``"burn_in"`` while
        ``state.step < burn_in_steps`` throughout the scan, ``"sampling"``
        when the scan starts at or after the boundary.  The sampling-phase
        scan stops carrying the frozen adaptation statistics through HBM —
        ~2x faster steps — with bitwise-identical positions.  ``None``
        (default) keeps the dynamic in-scan branch, correct for scans that
        cross the boundary.
    """
    if keep_every < 1:
        raise ValueError("sample_chain: keep_every must be >= 1")

    # Hoist the provably-constant part of the state (e.g. the frozen mass
    # matrix in the sampling phase) out of the scan carry: it becomes a
    # closure constant of the scan body, so XLA keeps it resident instead
    # of threading it through HBM every iteration.
    dynamic, frozen = sampler.partition_frozen(state, phase=phase)

    def one_step(carry, _):
        dynamic, key = carry
        key, key_step, key_batch = jax.random.split(key, 3)
        batch = batch_fn(key_batch) if batch_fn is not None else None
        state = sampler.merge_frozen(dynamic, frozen)
        state, info = sampler.step(state, key_step, batch, phase=phase)
        dynamic, _ = sampler.partition_frozen(state, phase=phase)
        return (dynamic, key), info

    def thinned_step(carry, _):
        carry, info = jax.lax.scan(one_step, carry, None, length=keep_every)
        dynamic, _ = carry
        last_cost = jax.tree_util.tree_map(lambda x: x[-1], info.cost)
        state = sampler.merge_frozen(dynamic, frozen)
        return carry, (sampler.position(state), last_cost)

    (dynamic, _), (positions, costs) = jax.lax.scan(
        thinned_step, (dynamic, key), None, length=n_samples
    )
    state = sampler.merge_frozen(dynamic, frozen)
    if not collect_costs:
        return state, positions
    return state, positions, costs


class IterativeSampler:
    """Iterator facade over a functional sampler for reference-API parity.

    Preserves the ``sample, cost = next(sampler)`` protocol of the reference
    (``base_classes.py:226-310``), including the convention that a
    single-parameter list is unraveled to a bare array
    (``base_classes.py:302-304``).  Each ``next`` runs one jitted step; for
    throughput, prefer :func:`sample_chain`.

    Parameters
    ----------
    sampler : MCMCSampler
        A functional sampler instance.
    params : pytree
        Initial position.  A list of arrays mirrors the reference's
        ``params`` list; any pytree works.
    key : jax.random key or int seed
    batch_generator : iterable or callable, optional
        Either a host-side iterable yielding batches (reference parity,
        ``data_batches.py``) or a pure ``(key) -> batch`` function.
    """

    def __init__(self, sampler, params, key=0, batch_generator=None):
        self.sampler = sampler
        if isinstance(key, int):
            key = jax.random.PRNGKey(key)
        self._key, init_key = jax.random.split(key)
        self._unravel_singleton = (
            isinstance(params, (list, tuple)) and len(params) == 1
        )
        self.state = sampler.init(params, init_key)
        self.batch_generator = batch_generator
        self._batch_is_callable = callable(batch_generator)
        self._jitted_step = jax.jit(sampler.step)
        self.n_iterations = 0

    def __iter__(self):
        return self

    def __next__(self):
        self._key, key_step, key_batch = jax.random.split(self._key, 3)
        if self.batch_generator is None:
            batch = None
        elif self._batch_is_callable:
            batch = self.batch_generator(key_batch)
        else:
            batch = next(self.batch_generator)
        self.state, info = self._jitted_step(self.state, key_step, batch)
        self.n_iterations += 1
        position = self.sampler.position(self.state)
        if self._unravel_singleton:
            position = position[0]
        return position, info.cost

    @property
    def is_burning_in(self):
        """True while the sampler is still adapting (cf. ``base_classes.py:393-406``)."""
        burn_in_steps = getattr(self.sampler, "burn_in_steps", 0)
        return self.n_iterations < burn_in_steps

    def take(self, n):
        """Collect ``n`` ``(sample, cost)`` pairs host-side."""
        return list(itertools.islice(self, n))
