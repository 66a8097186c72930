"""Each sampler's ``step`` against a plain transcription of its update rule.

The transcriptions below are written from the reference's published update
rules (cited in each sampler module) in float64 numpy, independently of
the samplers' ``jnp`` code.  Given the same gradient and the same injected
noise, one step must agree to float32 rounding, for every sampler, on both
sides of the burn-in boundary and with the network evaluated in float32 or
bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysgmcmc_tpu.samplers import (
    PSGLDSampler,
    RelativisticSGHMCSampler,
    SGHMCSampler,
    SGLDSampler,
    SGNHTSampler,
)
from pysgmcmc_tpu.samplers.base import sample_chain

EPS = 0.01
SCALE_GRAD = 50.0
PRIOR = 0.02


def _cost(compute_dtype):
    """Quadratic-tanh toy likelihood, evaluated in ``compute_dtype``."""

    def cost(params, batch):
        w = params["w"].astype(compute_dtype)
        b = params["b"].astype(compute_dtype)
        pred = jnp.tanh(batch[0].astype(compute_dtype) @ w + b)
        err = pred.astype(jnp.float32)[:, 0] - batch[1]
        return 0.5 * jnp.sum(err**2)

    return cost


def _make(name, cost):
    common = dict(stepsize_schedule=EPS, gaussian_prior_scale=PRIOR)
    if name == "SGHMC":
        return SGHMCSampler(cost, burn_in_steps=3, scale_grad=SCALE_GRAD,
                            mdecay=0.05, **common)
    if name == "SGLD":
        return SGLDSampler(cost, burn_in_steps=3, scale_grad=SCALE_GRAD,
                           A=0.7, **common)
    if name == "pSGLD":
        return PSGLDSampler(cost, scale_grad=SCALE_GRAD, alpha=0.9,
                            lambda_reg=1e-3, **common)
    if name == "SGNHT":
        return SGNHTSampler(cost, scale_grad=SCALE_GRAD, a_diff=0.8,
                            **common)
    return RelativisticSGHMCSampler(cost, mass=1.3, speed_of_light=0.9,
                                    D=1.1, Bhat=0.2, **common)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _reference_step(name, sampler, state, grad, eta, phase):
    """One step of the reference rule in float64 numpy.  ``grad`` is the
    cost gradient without the folded prior; returns the new position and
    the sampler-specific carried state."""
    st = _f64(state)
    grad = _f64(grad)
    eta = _f64(eta)
    g = {k: grad[k] + PRIOR * st.position[k] for k in grad}
    small = 1e-16

    if name in ("SGHMC", "SGLD"):
        # Springenberg et al. self-tuning burn-in (sghmc.py:126-196): the
        # step uses minv = 1/sqrt(OLD v_hat) while adapting, the frozen
        # minv afterwards
        if phase == "burn_in":
            minv = {k: 1.0 / (np.sqrt(np.maximum(st.stats.v_hat[k], 0.0))
                              + small) for k in g}
        else:
            minv = st.stats.minv
        new_pos, extra = {}, {}
        for k in g:
            if name == "SGHMC":
                eps_s = EPS / np.sqrt(SCALE_GRAD)
                sigma = np.sqrt(np.maximum(
                    2.0 * eps_s**2 * sampler.mdecay * minv[k] - eps_s**4,
                    1e-16))
                v = (st.momentum[k] - EPS**2 * minv[k] * g[k]
                     - sampler.mdecay * st.momentum[k] + sigma * eta[k])
                new_pos[k] = st.position[k] + v
                extra[k] = v
            else:
                sigma = np.sqrt(2.0 * EPS * minv[k] * sampler.A / SCALE_GRAD)
                new_pos[k] = (st.position[k] - EPS * minv[k] * sampler.A
                              * g[k] + sigma * eta[k])
        return new_pos, extra

    if name == "pSGLD":
        # Li et al. 2016: RMSprop preconditioner, G = 1/(lambda + sqrt(V))
        new_pos, extra = {}, {}
        for k in g:
            v = sampler.alpha * st.v[k] + (1.0 - sampler.alpha) * g[k] ** 2
            precond = 1.0 / (sampler.lambda_reg + np.sqrt(v))
            new_pos[k] = (st.position[k] - 0.5 * EPS * precond * g[k]
                          + np.sqrt(EPS * precond / SCALE_GRAD) * eta[k])
            extra[k] = v
        return new_pos, extra

    if name == "SGNHT":
        # Ding et al. 2014: p <- p - xi eps p - eps g + sqrt(2 A eps) N,
        # theta <- theta + eps p, xi <- xi + eps (p.p / d - 1)
        sigma = np.sqrt(2.0 * sampler.a_diff * EPS / SCALE_GRAD)
        p = {k: st.momentum[k] - st.xi * EPS * st.momentum[k] - EPS * g[k]
             + sigma * eta[k] for k in g}
        new_pos = {k: st.position[k] + EPS * p[k] for k in g}
        d = sum(v.size for v in p.values())
        xi = st.xi + EPS * (sum(np.sum(v**2) for v in p.values()) / d - 1.0)
        return new_pos, (p, xi)

    # Lu et al. 2017 relativistic SGHMC (relativistic_sghmc.py:97-123)
    m, c = sampler.mass, sampler.speed_of_light

    def velocity(p):
        return EPS * p / (m * np.sqrt(p * p / (m**2 * c**2) + 1.0))

    new_pos, extra = {}, {}
    for k in g:
        p = st.momentum[k]
        p = (p - EPS * g[k]
             + np.sqrt(EPS * (2.0 * sampler.D - EPS * sampler.Bhat)) * eta[k]
             - sampler.D * velocity(p))
        new_pos[k] = st.position[k] + velocity(p)
        extra[k] = p
    return new_pos, extra


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", ["burn_in", "sampling"])
@pytest.mark.parametrize(
    "name", ["SGHMC", "SGLD", "pSGLD", "SGNHT", "RSGHMC"])
def test_step_matches_reference_rule(name, phase, compute_dtype):
    cost = _cost(jnp.dtype(compute_dtype))
    sampler = _make(name, cost)
    rng = np.random.RandomState(0)
    params = {"w": jnp.asarray(rng.normal(size=(3, 1)), jnp.float32),
              "b": jnp.asarray(rng.normal(size=(1,)), jnp.float32)}
    batch = (jnp.asarray(rng.normal(size=(8, 3)), jnp.float32),
             jnp.asarray(rng.normal(size=(8,)), jnp.float32))
    state = sampler.init(params, jax.random.PRNGKey(1))
    # a few steps first, so adaptation statistics and momenta are
    # non-trivial; the adaptive samplers then sit on the requested side
    # of their 3-step burn-in
    n_pre = 1 if phase == "burn_in" else 3
    state, _ = sample_chain(
        sampler, state, jax.random.PRNGKey(2), 1,
        batch_fn=lambda key: batch, keep_every=n_pre, collect_costs=False)
    eta = {"w": jnp.asarray(rng.normal(size=(3, 1)), jnp.float32),
           "b": jnp.asarray(rng.normal(size=(1,)), jnp.float32)}
    grad = jax.grad(cost)(state.position, batch)

    new_state, info = sampler.step(
        state, jax.random.PRNGKey(3), batch, noise=eta, phase=phase)
    want_pos, want_extra = _reference_step(
        name, sampler, state, grad, eta, phase)

    tol = dict(rtol=2e-5, atol=1e-6)
    for k in want_pos:
        np.testing.assert_allclose(
            np.asarray(new_state.position[k]), want_pos[k], **tol)
    if name in ("SGHMC", "RSGHMC"):
        for k in want_extra:
            np.testing.assert_allclose(
                np.asarray(new_state.momentum[k]), want_extra[k], **tol)
    elif name == "pSGLD":
        for k in want_extra:
            np.testing.assert_allclose(
                np.asarray(new_state.v[k]), want_extra[k], **tol)
    elif name == "SGNHT":
        p, xi = want_extra
        for k in p:
            np.testing.assert_allclose(
                np.asarray(new_state.momentum[k]), p[k], **tol)
        np.testing.assert_allclose(float(new_state.xi), xi, **tol)
    assert np.isfinite(float(info.cost))
    assert int(new_state.step) == int(state.step) + 1
