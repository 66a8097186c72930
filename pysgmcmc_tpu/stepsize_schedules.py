"""Stepsize schedules as pure, trace-friendly functions.

The reference models schedules as Python iterators with an ``update`` feedback
hook, evaluated host-side and fed into the graph once per step
(``/root/reference/pysgmcmc/stepsize_schedules.py:4-91``,
``samplers/base_classes.py:195-197``).  On an accelerator that per-step host round trip
would serialize the whole chain, so here a schedule is a pure function
``value(state, step) -> stepsize`` evaluated *inside* the jitted sampler step;
the feedback hook becomes an explicit ``update(state, info) -> state``
transition carried through ``lax.scan``.

For API parity the classes still support the iterator protocol
(``next(schedule)`` yields host-side floats), so reference-style code keeps
working.
"""

import jax.numpy as jnp


class StepsizeSchedule:
    """Base class: a schedule is ``(init, value, update)``.

    - ``init()``            -> schedule state (a pytree, may be ``()``)
    - ``value(state, step)``-> stepsize at integer step ``step`` (traceable)
    - ``update(state, **info)`` -> new schedule state (traceable)

    The iterator protocol is provided for parity with the reference API
    (``stepsize_schedules.py:12-23``): iterating yields ``value`` at
    successive steps using host-side state.
    """

    def __init__(self, initial_value):
        self.initial_value = initial_value
        self._host_step = 0
        self._host_state = self.init()

    def init(self):
        return ()

    def value(self, state, step):
        raise NotImplementedError

    def update(self, state, **info):
        """Feedback hook; default is a no-op (cf. ``stepsize_schedules.py:26-34``)."""
        return state

    def __iter__(self):
        return self

    def __next__(self):
        out = self.value(self._host_state, self._host_step)
        self._host_step += 1
        return float(out)


class ConstantStepsizeSchedule(StepsizeSchedule):
    """Constant stepsize (cf. ``stepsize_schedules.py:37-91``).

    Examples
    --------
    >>> schedule = ConstantStepsizeSchedule(0.01)
    >>> schedule.initial_value
    0.01
    >>> next(schedule)
    0.01
    >>> from itertools import islice
    >>> list(islice(schedule, 4))
    [0.01, 0.01, 0.01, 0.01]
    """

    def value(self, state, step):
        return self.initial_value

    def __str__(self):
        return "ConstantStepsizeSchedule(stepsize={})".format(self.initial_value)


class TracedStepsizeSchedule(StepsizeSchedule):
    """Constant stepsize carried in the (traced) schedule state.

    Unlike :class:`ConstantStepsizeSchedule` — whose value is a Python
    float baked into the compiled program — this schedule reads the
    stepsize from ``schedule_state``, so one compiled sampler program
    serves *any* stepsize: replace ``state.schedule_state`` (or vmap over
    it) to sweep stepsizes with zero recompilation.  This is what lets the
    whole ESS-vs-stepsize experiment (81 stepsizes x 20 chains in the
    reference, run sequentially there) execute as a single device program.
    """

    def init(self):
        # host-side numpy: no device allocation at schedule construction
        import numpy as np

        return np.float32(self.initial_value)

    def value(self, state, step):
        return state

    def __str__(self):
        return "TracedStepsizeSchedule(initial={})".format(self.initial_value)


class PolynomialDecaySchedule(StepsizeSchedule):
    """``a / (b + t)**gamma`` — the classic Welling & Teh SGLD decay.

    Satisfies the Robbins-Monro conditions for ``gamma in (0.5, 1]``.
    New capability relative to the reference (which only ships the constant
    schedule).
    """

    def __init__(self, a=0.01, b=1.0, gamma=0.55):
        self.a, self.b, self.gamma = a, b, gamma
        super().__init__(initial_value=self.a / self.b ** self.gamma)

    def value(self, state, step):
        step = jnp.asarray(step, dtype=jnp.float32)
        return self.a / (self.b + step) ** self.gamma

    def __str__(self):
        return "PolynomialDecaySchedule(a={}, b={}, gamma={})".format(
            self.a, self.b, self.gamma
        )


class CyclicalStepsizeSchedule(StepsizeSchedule):
    """Cosine cyclical stepsizes (Zhang et al., cSG-MCMC, ICLR 2020).

    ``eps_t = eps0/2 * (cos(pi * ((t-1) mod ceil(T/M)) / ceil(T/M)) + 1)``

    New capability relative to the reference; useful for multimodal targets.
    """

    def __init__(self, initial_value, cycle_length):
        self.cycle_length = int(cycle_length)
        super().__init__(initial_value=initial_value)

    def value(self, state, step):
        phase = jnp.mod(jnp.asarray(step, jnp.float32), self.cycle_length)
        return (
            0.5
            * self.initial_value
            * (jnp.cos(jnp.pi * phase / self.cycle_length) + 1.0)
        )

    def __str__(self):
        return "CyclicalStepsizeSchedule(stepsize={}, cycle_length={})".format(
            self.initial_value, self.cycle_length
        )
