"""Convergence diagnostics, computed on device.

The reference delegates ESS and Gelman-Rubin to pymc3 over host-side traces
(``/root/reference/pysgmcmc/diagnostics/sampler_diagnostics.py:7-44``); here
both are implemented natively over device-resident chain histories of shape
``(n_chains, n_samples, ...)`` so they jit, vmap over parameter dimensions,
and — when the chain axis is sharded over a mesh — turn the pooled
between-chain statistics into collectives inserted by GSPMD.

Formulae (Gelman et al., Bayesian Data Analysis 3rd ed., ch. 11.4-11.5 —
the same estimators pymc3 implements):

- ESS:  ``n_eff = m n / (1 + 2 sum_t rho_t)`` with the lag correlations
  ``rho_t = 1 - (W - mean_acov_t) / var_plus`` estimated from per-chain FFT
  autocovariances and truncated by Geyer's initial monotone positive
  sequence (cf. the formula quoted in the reference's docstring,
  ``sampler_diagnostics.py:76-82``).
- PSRF: ``R_hat = sqrt(var_plus / W)``, ``var_plus = (n-1)/n W + B/n``
  (cf. ``sampler_diagnostics.py:150-161``).

Examples
--------
>>> import numpy as np
>>> chains = np.random.default_rng(0).standard_normal((2, 500))
>>> ess = float(effective_sample_size(chains))
>>> bool(600 < ess <= 1000)  # iid draws: ESS near the total draw count
True
>>> bool(float(gelman_rubin(chains)) < 1.05)
True
>>> bool(float(gelman_rubin_split(chains)) < 1.05)
True
"""

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri


def _autocovariance(x):
    """Per-chain autocovariance via FFT. ``x``: (m, n) -> (m, n), biased (1/n)."""
    m, n = x.shape
    x = x - jnp.mean(x, axis=1, keepdims=True)
    nfft = 1 << (2 * n - 1).bit_length()
    f = jnp.fft.rfft(x, nfft, axis=1)
    acov = jnp.fft.irfft(f * jnp.conj(f), nfft, axis=1)[:, :n]
    return acov / n


def _scalar_ess(chains):
    """ESS for one scalar variable. ``chains``: (m, n) array."""
    m, n = chains.shape
    acov = _autocovariance(chains)
    mean_acov = jnp.mean(acov, axis=0)  # (n,)

    # Within-chain variance (unbiased) and pooled variance estimate.
    within = jnp.mean(acov[:, 0] * n / (n - 1.0))
    if m > 1:
        chain_means = jnp.mean(chains, axis=1)
        between = n * jnp.var(chain_means, ddof=1)
    else:
        between = jnp.zeros((), chains.dtype)
    var_plus = within * (n - 1.0) / n + between / n

    rho = 1.0 - (within - mean_acov) / var_plus  # (n,), rho[0] ~= 1

    # Geyer initial monotone positive sequence over lag pairs
    # (rho_1+rho_2), (rho_3+rho_4), ...  Keep pairs until the first
    # negative sum, then enforce monotone non-increase; tau = 1 + 2*sum.
    n_pairs = (n - 1) // 2
    pair_sums = rho[1 : 1 + 2 * n_pairs].reshape(n_pairs, 2).sum(axis=1)
    positive = jnp.cumprod(pair_sums > 0.0).astype(bool)
    monotone = jax.lax.associative_scan(jnp.minimum, pair_sums)
    kept = jnp.where(positive, jnp.maximum(monotone, 0.0), 0.0)
    tau = 1.0 + 2.0 * jnp.sum(kept)

    ess = m * n / tau
    ess = jnp.clip(ess, 0.0, m * n)
    # A non-finite chain (diverged sampler) yields NaN autocovariances,
    # which truncate Geyer's sum at the first pair and would report the
    # *maximum* ESS m*n — the most misleading possible answer.  Propagate
    # NaN instead so diverged chains are unmistakable downstream.
    return jnp.where(jnp.all(jnp.isfinite(chains)), ess, jnp.nan)


def _is_array_like(x):
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _chains_matrix(chains):
    """(m, n, *shape) -> (m, n, prod(shape)) with at least one variable column."""
    chains = jnp.asarray(chains)
    if chains.ndim < 2:
        raise ValueError(
            "diagnostics need chains of shape (n_chains, n_samples, ...); "
            "got shape {}".format(chains.shape)
        )
    m, n = chains.shape[:2]
    return chains.reshape(m, n, -1)


def effective_sample_size(chains):
    """ESS per variable dimension.

    ``chains``: array of shape ``(n_chains, n_samples, *variable_shape)``
    (or a pytree thereof).  Returns an array of shape ``variable_shape``
    (scalar for 2-D input), or a matching pytree.
    """
    if not _is_array_like(chains):
        return jax.tree_util.tree_map(effective_sample_size, chains)
    matrix = _chains_matrix(chains)
    ess = jax.vmap(_scalar_ess, in_axes=2)(matrix)
    shape = jnp.shape(chains)[2:]
    return ess.reshape(shape) if shape else ess[0]


def gelman_rubin(chains):
    """Potential scale reduction factor R_hat per variable dimension.

    ``chains``: array of shape ``(n_chains, n_samples, *variable_shape)``
    with at least two chains, or a pytree thereof.
    """
    if not _is_array_like(chains):
        return jax.tree_util.tree_map(gelman_rubin, chains)
    matrix = _chains_matrix(chains)
    m, n = matrix.shape[:2]
    if m < 2:
        raise ValueError("gelman_rubin requires at least two chains")

    chain_means = jnp.mean(matrix, axis=1)  # (m, v)
    between = n * jnp.var(chain_means, axis=0, ddof=1)  # (v,)
    within = jnp.mean(jnp.var(matrix, axis=1, ddof=1), axis=0)  # (v,)
    var_plus = (n - 1.0) / n * within + between / n
    r_hat = jnp.sqrt(var_plus / within)

    shape = jnp.shape(chains)[2:]
    return r_hat.reshape(shape) if shape else r_hat[0]


#  Rank-normalized split diagnostics (Vehtari, Gelman, Simpson, Carpenter &
#  Buerkner, "Rank-normalization, folding, and localization: an improved
#  R-hat for assessing convergence of MCMC", Bayesian Analysis 2021) — the
#  estimators modern pymc/arviz report.  They serve here as an *independent*
#  second implementation for cross-validating the classic Gelman et al.
#  estimators above (see tests/diagnostics/test_ess_external.py: both are
#  tested against closed-form AR(1)/offset ground truth), and as a
#  capability addition: split-R_hat detects within-chain nonstationarity
#  (e.g. a still-drifting chain) that classic R_hat structurally cannot.


def _split_chains(matrix):
    """(m, n, v) -> (2m, n//2, v): split every chain into halves."""
    m, n = matrix.shape[:2]
    half = n // 2
    first = matrix[:, :half]
    second = matrix[:, n - half:]
    return jnp.concatenate([first, second], axis=0)


def _rank_normalize(matrix):
    """Fractional-rank normal transform over pooled draws (per variable).

    ranks are averaged-tie-free (argsort of argsort); the normal scores use
    the Blom offset ``(r - 3/8) / (S + 1/4)`` as in the published method.
    """
    m, n, v = matrix.shape
    pooled = matrix.reshape(m * n, v)
    order = jnp.argsort(pooled, axis=0)
    # scatter ranks: rank[order[i], col] = i + 1
    iota = jnp.arange(1, m * n + 1, dtype=pooled.dtype)[:, None]
    cols = jnp.broadcast_to(jnp.arange(v)[None, :], order.shape)
    ranks = jnp.zeros((m * n, v), pooled.dtype).at[order, cols].set(
        jnp.broadcast_to(iota, order.shape)
    )
    z = ndtri((ranks - 0.375) / (m * n + 0.25))
    return z.reshape(m, n, v)


def gelman_rubin_split(chains, rank_normalized=True):
    """Split-R_hat (rank-normalized by default) per variable dimension.

    Accepts ``(n_chains, n_samples, *variable_shape)`` arrays (or pytrees);
    unlike classic :func:`gelman_rubin`, a single chain is allowed (its two
    halves form the comparison), and within-chain drift inflates the
    statistic.  Values near 1.01 or below indicate convergence.
    """
    if not _is_array_like(chains):
        return jax.tree_util.tree_map(
            lambda leaf: gelman_rubin_split(leaf, rank_normalized), chains
        )
    matrix = _split_chains(_chains_matrix(chains))
    if rank_normalized:
        matrix = _rank_normalize(matrix)
    m, n, v = matrix.shape
    chain_means = jnp.mean(matrix, axis=1)
    between = n * jnp.var(chain_means, axis=0, ddof=1)
    within = jnp.mean(jnp.var(matrix, axis=1, ddof=1), axis=0)
    var_plus = (n - 1.0) / n * within + between / n
    r_hat = jnp.sqrt(var_plus / within)
    shape = jnp.shape(chains)[2:]
    return r_hat.reshape(shape) if shape else r_hat[0]


def effective_sample_size_bulk(chains):
    """Bulk-ESS: rank-normalized split-chain effective sample size.

    The Vehtari et al. (2021) estimator reported by modern pymc/arviz as
    ``ess_bulk``: chains are split in half, rank-normal transformed, and the
    classic multi-chain autocorrelation ESS is taken on the transformed
    draws.  Robust to heavy tails and to within-chain trend.
    """
    if not _is_array_like(chains):
        return jax.tree_util.tree_map(effective_sample_size_bulk, chains)
    matrix = _split_chains(_chains_matrix(chains))
    # Rank-normalization maps non-finite draws to finite normal scores, so
    # the _scalar_ess NaN guard would never fire — mask per variable from
    # the raw draws instead (diverged chain => NaN, as in the classic ESS).
    finite = jnp.all(jnp.isfinite(matrix), axis=(0, 1))
    ess = jax.vmap(_scalar_ess, in_axes=2)(_rank_normalize(matrix))
    ess = jnp.where(finite, ess, jnp.nan)
    shape = jnp.shape(chains)[2:]
    return ess.reshape(shape) if shape else ess[0]


def effective_sample_sizes(
    sampler,
    initial_position,
    key,
    n_chains=2,
    samples_per_chain=100,
    keep_every=10,
    batch_fn=None,
    jitter=0.0,
    mesh=None,
):
    """Run ``n_chains`` parallel chains and return per-variable ESS.

    API-parity convenience mirroring the reference entry point
    (``sampler_diagnostics.py:47-115``), except chains run *in parallel* via
    ``vmap`` (optionally sharded over ``mesh``) instead of sequentially.
    Returns a pytree shaped like ``initial_position``.
    """
    chains = _multichain(
        sampler, initial_position, key, n_chains, samples_per_chain,
        keep_every, batch_fn, jitter, mesh,
    )
    return jax.tree_util.tree_map(
        lambda leaf: effective_sample_size(leaf), chains
    )


def gelman_rubin_from_sampler(
    sampler,
    initial_position,
    key,
    n_chains=2,
    samples_per_chain=100,
    keep_every=10,
    batch_fn=None,
    jitter=1.0,
    mesh=None,
):
    """Run ``n_chains`` parallel chains and return per-variable R_hat.

    API-parity convenience mirroring ``sampler_diagnostics.py:118-194``.
    Chains are jitter-overdispersed by default, as the PSRF assumes.
    """
    chains = _multichain(
        sampler, initial_position, key, n_chains, samples_per_chain,
        keep_every, batch_fn, jitter, mesh,
    )
    return jax.tree_util.tree_map(lambda leaf: gelman_rubin(leaf), chains)


def _multichain(
    sampler, initial_position, key, n_chains, samples_per_chain,
    keep_every, batch_fn, jitter, mesh,
):
    from pysgmcmc_tpu.parallel.chains import run_chains, stack_positions

    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    key_init, key_run = jax.random.split(key)
    positions = stack_positions(
        initial_position, n_chains, jitter=jitter, key=key_init
    )
    chains, _ = run_chains(
        sampler,
        positions,
        key_run,
        samples_per_chain,
        batch_fn=batch_fn,
        keep_every=keep_every,
        mesh=mesh,
    )
    return chains
