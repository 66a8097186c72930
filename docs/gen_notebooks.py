"""Generate the executed paper-reproduction notebooks.

Counterparts of the reference's executable documentation
(``/root/reference/docs/source/notebooks/{api_quickstart,
Relativistic_SGHMC,SVGD}.ipynb``, executed in its CI via nbval,
``/root/reference/pysgmcmc/Makefile:10-14``): each notebook below is a
list of (markdown, code) cells executed top to bottom by
``docs/nbgen.py`` and written as a genuine nbformat-4 ``.ipynb`` with
captured stdout and rendered figures.  Wired into ``make docs`` so the
committed notebooks can never go stale relative to the API.

Usage: ``JAX_PLATFORMS=cpu python docs/gen_notebooks.py [output_dir]``
(defaults to ``docs/notebooks/``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nbgen import run_notebook, write_notebook  # noqa: E402

RELATIVISTIC_SGHMC = [
    ("""
     ## Relativistic SGHMC — "Relativistic Monte Carlo"

     This notebook reproduces the qualitative results of
     [Lu et al., AISTATS 2017](http://proceedings.mlr.press/v54/lu17b/lu17b.pdf):
     sampling benchmark densities with *relativistic* Hamiltonian dynamics,
     whose speed-of-light bound on the momentum makes the sampler robust to
     large gradients and stepsizes (counterpart of the reference notebook
     `docs/source/notebooks/Relativistic_SGHMC.ipynb`).

     We start by plotting the log-likelihoods of the 2-D objective
     functions used throughout.
     """,
     """
     import jax
     import jax.numpy as jnp
     import numpy as np
     import matplotlib.pyplot as plt

     from pysgmcmc_tpu.diagnostics.objective_functions import (
         banana_log_likelihood,
         gmm1_log_likelihood,
         to_negative_log_likelihood,
     )

     def banana_grid(n=160):
         gx, gy = jnp.meshgrid(jnp.linspace(-25, 25, n),
                               jnp.linspace(-30, 12, n))
         grid = jnp.stack([gx.ravel(), gy.ravel()], axis=-1)
         z = jax.vmap(banana_log_likelihood)(grid).reshape(gx.shape)
         return np.asarray(gx), np.asarray(gy), np.asarray(z)

     fig, axes = plt.subplots(1, 2, figsize=(10, 4))
     gx, gy, z = banana_grid()
     axes[0].contourf(gx, gy, z, levels=30, cmap="viridis")
     axes[0].set_title("banana log-likelihood (2-D)")

     xs = jnp.linspace(-9.0, 9.0, 400)
     dens = jax.vmap(lambda v: gmm1_log_likelihood(v))(xs)
     axes[1].plot(np.asarray(xs), np.exp(np.asarray(dens)))
     axes[1].set_title("gmm1 density (1-D, modes at -5/0/+5)")
     plt.tight_layout()
     """),
    ("""
     ### Extract samples and plot them

     Below we draw samples from each target with
     `RelativisticSGHMCSampler` and scatter them over the density.  Unlike
     the reference — which builds a TF graph and calls `session.run` once
     per sample — the whole chain is one `lax.scan` inside a single jitted
     program, and the scatter data never leaves the device until the final
     fetch.
     """,
     """
     from pysgmcmc_tpu.samplers import RelativisticSGHMCSampler, sample_chain

     fig, axes = plt.subplots(1, 2, figsize=(10, 4))

     # banana: 2-D scatter over the contours
     cost_fn = to_negative_log_likelihood(banana_log_likelihood)
     sampler = RelativisticSGHMCSampler(cost_fn, stepsize_schedule=0.1)
     state = sampler.init(jnp.zeros(2), key=jax.random.PRNGKey(0))
     state, samples, costs = sample_chain(
         sampler, state, jax.random.PRNGKey(1), n_samples=50_000)
     b = np.asarray(samples)[10_000:]
     gx, gy, z = banana_grid()
     axes[0].contourf(gx, gy, z, levels=30, cmap="viridis")
     axes[0].plot(b[:, 0], b[:, 1], "r.", markersize=1, alpha=0.15)
     axes[0].set_title("RSGHMC samples on banana")
     print(f"banana: kept {len(b)} samples, x0 mean {b[:, 0].mean():+.2f}")

     # gmm1: 1-D histogram against the true density
     cost_fn = to_negative_log_likelihood(gmm1_log_likelihood)
     sampler = RelativisticSGHMCSampler(cost_fn, stepsize_schedule=0.25)
     state = sampler.init(jnp.zeros(1), key=jax.random.PRNGKey(2))
     state, samples, _ = sample_chain(
         sampler, state, jax.random.PRNGKey(3), n_samples=50_000)
     g = np.asarray(samples)[10_000:, 0]
     axes[1].hist(g, bins=80, density=True, alpha=0.6, label="RSGHMC")
     xs = jnp.linspace(-9.0, 9.0, 400)
     dens = jax.vmap(lambda v: gmm1_log_likelihood(v))(xs)
     axes[1].plot(np.asarray(xs), np.exp(np.asarray(dens)), "k-",
                  label="true density")
     axes[1].legend()
     axes[1].set_title("RSGHMC samples on gmm1")
     for mode in (-5, 0, 5):
         mass = np.mean(np.abs(g - mode) < 1.5)
         print(f"gmm1 mass near mode {mode:+d}: {mass:.2f} (target 0.33)")
     plt.tight_layout()
     """),
    ("""
     The banana samples track the curved ridge `x1 = 10 - 0.1 x0^2` across
     its full width — the regime the paper highlights, where classical
     HMC's momenta either stall in the ridge or overshoot it — and the
     gmm1 chain crosses between all three modes.
     """,
     """
     residual = b[:, 1] + 0.1 * b[:, 0] ** 2 - 10.0
     print(f"x0 spread (std):          {b[:, 0].std():.2f}  (ridge ~7)")
     print(f"ridge residual mean/std:  {residual.mean():+.3f} / "
           f"{residual.std():.3f}  (should be ~N(0, 1))")
     """),
    ("""
     ### Diagnostics: effective sample size vs stepsize

     The paper (and the reference's ESS experiment,
     `docs/source/experiments/compute_ess.py`) characterizes samplers by
     how the effective sample size of the chain varies with stepsize.
     Here we run a live mini-sweep — every stepsize's 4 chains are one
     vmapped device program, and the ESS estimator is the framework's own
     FFT-based implementation rather than a pymc3 call.  (Full-protocol
     sweeps — 20 chains x 10k samples per stepsize — are produced by
     `examples/compute_ess.py`.)
     """,
     """
     from pysgmcmc_tpu.diagnostics.sampler_diagnostics import (
         effective_sample_size,
     )

     stepsizes = [0.05, 0.1, 0.25, 0.5, 1.0, 1.8, 2.5]
     n_chains, n_samples = 4, 2_000
     cost_fn = to_negative_log_likelihood(banana_log_likelihood)

     def sweep_one(stepsize):
         sampler = RelativisticSGHMCSampler(
             cost_fn, stepsize_schedule=float(stepsize))

         def one_chain(key):
             k_init, k_run = jax.random.split(key)
             state = sampler.init(jnp.zeros(2), key=k_init)
             _, samples, _ = sample_chain(
                 sampler, state, k_run, n_samples=n_samples, keep_every=10)
             return samples

         keys = jax.random.split(jax.random.PRNGKey(4), n_chains)
         chains = jax.jit(jax.vmap(one_chain))(keys)
         return float(jnp.mean(effective_sample_size(chains)))

     ess_values = [sweep_one(s) for s in stepsizes]
     for s, e in zip(stepsizes, ess_values):
         print(f"stepsize {s:4.2f}: mean ESS {e:8.1f}")

     plt.figure(figsize=(6, 4))
     plt.plot(stepsizes, ess_values, "o-")
     plt.xlabel("stepsize $\\\\epsilon$")
     plt.ylabel("mean ESS (%d chains x %d kept)" % (n_chains, n_samples))
     plt.title("Relativistic SGHMC on banana: ESS vs stepsize")
     plt.grid(alpha=0.3)
     """),
    ("""
     As in the paper, ESS *grows* with stepsize well past the point where
     non-relativistic samplers diverge — the momentum's speed-of-light cap
     turns too-large steps into saturated (not exploding) moves.
     """,
     None),
]

SVGD = [
    ("""
     ## Stein Variational Gradient Descent

     This notebook shows `SVGDSampler` transporting a particle ensemble
     onto the banana density from
     [Relativistic Monte Carlo (Lu et al., 2017)](http://proceedings.mlr.press/v54/lu17b/lu17b.pdf)
     — the counterpart of the reference's
     `docs/source/notebooks/SVGD.ipynb`.  SVGD is not an MCMC chain: all
     particles move *together* downhill on the KL objective, coupled by an
     RBF kernel (median-heuristic bandwidth) that pushes them apart.  The
     particle-pairwise kernel is one Gram-matrix product; here it runs on
     the CPU.
     """,
     """
     import jax
     import jax.numpy as jnp
     import numpy as np
     import matplotlib.pyplot as plt

     from pysgmcmc_tpu.diagnostics.objective_functions import (
         banana_log_likelihood,
         to_negative_log_likelihood,
     )
     from pysgmcmc_tpu.samplers import SVGDSampler

     cost_fn = to_negative_log_likelihood(banana_log_likelihood)
     sampler = SVGDSampler(cost_fn, stepsize_schedule=1.0)

     particles0 = jax.random.normal(
         jax.random.PRNGKey(0), (500, 2)) * 0.5 + jnp.array([0.0, -15.0])
     state = sampler.init(particles0)

     step = jax.jit(sampler.step)
     snapshots = {0: np.asarray(state.position)}
     for i in range(3000):
         state, info = step(state, jax.random.PRNGKey(i))
         if i + 1 in (300, 3000):
             snapshots[i + 1] = np.asarray(state.position)
     print("ran 3000 SVGD updates over 500 particles")
     """),
    ("""
     ### Particle transport

     Left to right: the badly-initialized cloud, an intermediate state,
     and the converged ensemble spread along the banana ridge.
     """,
     """
     gx, gy = jnp.meshgrid(jnp.linspace(-25, 25, 160),
                           jnp.linspace(-30, 12, 160))
     grid = jnp.stack([gx.ravel(), gy.ravel()], axis=-1)
     z = jax.vmap(banana_log_likelihood)(grid).reshape(gx.shape)

     fig, axes = plt.subplots(1, 3, figsize=(13, 4), sharex=True,
                              sharey=True)
     for ax, (it, cloud) in zip(axes, sorted(snapshots.items())):
         ax.contourf(np.asarray(gx), np.asarray(gy), np.asarray(z),
                     levels=30, cmap="viridis")
         ax.plot(cloud[:, 0], cloud[:, 1], "r.", markersize=2.5)
         ax.set_title(f"iteration {it}")
     plt.tight_layout()

     final = snapshots[3000]
     residual = final[:, 1] + 0.1 * final[:, 0] ** 2 - 10.0
     print(f"final x0 spread (std):   {final[:, 0].std():.2f}")
     print(f"ridge residual mean/std: {residual.mean():+.3f} / "
           f"{residual.std():.3f}")
     """),
    ("""
     The ensemble covers the ridge symmetrically — the kernel's repulsive
     term is what keeps 500 deterministic gradient-followers from
     collapsing into the single mode a plain optimizer would find.  For
     particle counts where the n x n kernel matrix no longer fits in
     device memory, the streaming variant (`ops/svgd_streaming.py`,
     `SVGDSampler(kernel_impl="streaming")`) computes the same update
     without ever materializing it.
     """,
     None),
]

API_QUICKSTART = [
    ("""
     ## API quickstart

     A tour of the framework surface, section for section the counterpart
     of the reference's `docs/source/notebooks/api_quickstart.ipynb` —
     with the TF-1 session/graph machinery replaced by pure functions:
     a sampler is an `init/step` pair, a chain is one `jax.lax.scan`,
     and everything composes with `jit`/`vmap`/`shard_map`.
     """,
     """
     import itertools

     import jax
     import jax.numpy as jnp
     import numpy as np
     import matplotlib.pyplot as plt
     """),
    ("""
     ### 1. Instantiating a sampler

     Two ingredients (exactly as in the reference):

     1. **target parameters** — here any JAX pytree (a bare array, a list
        of arrays like the reference's `tf.Variable` list, or a nested
        dict of weights), and
     2. **a cost function** mapping those parameters to a scalar cost
        (the negative log likelihood, in MCMC terms $-\\log p(\\theta)$).

     Instantiate directly or through the `Sampler` enum factory
     (`pysgmcmc_tpu.sampling.Sampler.get_sampler`, the reference's
     reflection factory).  There is no session: `sampler.init` builds the
     chain state, `sampler.step` advances it.
     """,
     """
     from pysgmcmc_tpu import Sampler
     from pysgmcmc_tpu.diagnostics.objective_functions import (
         banana_log_likelihood,
         to_negative_log_likelihood,
     )

     banana_nll = to_negative_log_likelihood(banana_log_likelihood)

     sampler = Sampler.get_sampler(
         Sampler.SGHMC, cost_fn=banana_nll,
         stepsize_schedule=0.1, burn_in_steps=500)

     state = sampler.init(jnp.zeros(2))
     state, info = sampler.step(state, jax.random.PRNGKey(0))
     print("one step:", np.asarray(state.position),
           "cost", float(info.cost))
     print("available samplers:", [s.value for s in Sampler
                                   if Sampler.is_supported(s)])
     """),
    ("""
     ### Using data minibatches

     Stochastic-gradient MCMC subsamples the dataset each step.  The
     reference feeds host-side generator batches through placeholders;
     here `data_batches.batch_fn` builds a *pure on-device selector*
     `key -> (x_batch, y_batch)` that the sampler draws from inside the
     compiled chain (host generators are also supported for API parity).
     """,
     """
     from pysgmcmc_tpu.data_batches import batch_fn
     from pysgmcmc_tpu.diagnostics.objective_functions import sinc

     rng = np.random.RandomState(0)
     x_train = jnp.asarray(rng.uniform(0, 1, (100, 1)), jnp.float32)
     y_train = jnp.asarray(np.asarray(sinc(np.asarray(x_train))),
                           jnp.float32)
     select_batch = batch_fn(x_train, y_train, batch_size=20)
     xb, yb = select_batch(jax.random.PRNGKey(3))
     print("one minibatch:", xb.shape, yb.shape)
     """),
    ("""
     ### Sampler hyperparameters

     Each sampler documents its update rule and hyperparameters in its
     docstring (`help(SGHMCSampler)` for the full text); the constructor
     surface mirrors the reference's.
     """,
     """
     import inspect

     from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler

     print("SGHMCSampler", inspect.signature(SGHMCSampler.__init__))
     """),
    ("""
     ### 2. Extracting samples

     The reference's iterator protocol is preserved verbatim by
     `IterativeSampler`: `sample, cost = next(sampler)`, `itertools`
     composition, infinite `for` loops.  Each `next` is one jitted step
     — fine for interactive use.
     """,
     """
     from pysgmcmc_tpu.samplers import IterativeSampler

     # a list of parameters, exactly like the reference's tf.Variable list
     it = IterativeSampler(
         sampler, [jnp.zeros(()), jnp.zeros(())], key=1)
     sample, cost = next(it)
     print("next(sampler) ->", [float(s) for s in sample], float(cost))

     samples = [s for s, _ in itertools.islice(it, 5)]
     print("islice gave", len(samples), "samples")
     """),
    ("""
     For throughput, extract a whole chain as ONE compiled program
     instead: `sample_chain` runs the entire loop as a `jax.lax.scan`
     on device (the difference is not cosmetic — per-`next` dispatch is
     what limited the reference to one host round trip per step).
     """,
     """
     from pysgmcmc_tpu.samplers import sample_chain

     state = sampler.init(jnp.zeros(2))
     state, positions, costs = sample_chain(
         sampler, state, jax.random.PRNGKey(2), 3000)
     print("chain:", positions.shape, "finite:",
           bool(np.isfinite(np.asarray(positions)).all()))
     """),
    ("""
     ### 3. Analyzing chains

     Multiple chains are one `vmap` (and, on a pod slice, one
     `shard_map` over the device mesh).  Diagnostics are native and
     on-device — effective sample size (FFT autocovariance + Geyer
     truncation) and the Gelman-Rubin potential scale reduction factor —
     and any trace exports to ArviZ `InferenceData` for the wider
     ecosystem (the modern counterpart of the reference's pymc3
     `MultiTrace` interop).
     """,
     """
     from pysgmcmc_tpu.diagnostics.sampler_diagnostics import (
         effective_sample_size,
         gelman_rubin,
     )

     def one_chain(key):
         k1, k2 = jax.random.split(key)
         st = sampler.init(jnp.zeros(2), k1)
         _, pos, _ = sample_chain(sampler, st, k2, 3000)
         return pos

     chains = jax.vmap(one_chain)(
         jax.random.split(jax.random.PRNGKey(4), 4))  # (4, 3000, 2)
     kept = chains[:, 500:]
     print("ESS  ", np.asarray(effective_sample_size(kept)).round(1))
     print("R-hat", np.asarray(gelman_rubin(kept)).round(3))

     fig, axes = plt.subplots(1, 2, figsize=(10, 3.6))
     for c in range(kept.shape[0]):
         axes[0].plot(np.asarray(kept[c, :, 1]), lw=0.4, alpha=0.7)
     axes[0].set_title("trace of $\\\\theta_2$, 4 chains")
     axes[1].hist2d(*np.asarray(kept.reshape(-1, 2)).T, bins=60,
                    cmap="viridis")
     axes[1].set_title("pooled banana posterior")
     plt.tight_layout()
     """),
    ("""
     ### 4. A sampler-trained Bayesian neural network

     `BayesianNeuralNetwork` trains the reference's 3x50-tanh
     heteroscedastic architecture with any of the samplers; training is
     compiled scans (optionally thousands of parallel chains, see
     `docs/intro.md`), prediction is one vmap over the sampled ensemble.
     """,
     """
     from pysgmcmc_tpu.models.bayesian_neural_network import (
         BayesianNeuralNetwork,
     )

     rng = np.random.RandomState(1)
     x = rng.uniform(0, 1, (32, 1))
     y = np.asarray(sinc(x))

     bnn = BayesianNeuralNetwork(
         n_nets=40, burn_in_steps=1000, n_iters=3000,
         sample_steps=50, seed=0)
     bnn.train(x, y)
     grid = np.linspace(0, 1, 120)[:, None]
     mean, var = bnn.predict(grid)

     plt.figure(figsize=(7.5, 4))
     plt.plot(grid, np.asarray(sinc(grid)), "k--", lw=1, label="sinc")
     plt.plot(x, y, "ko", ms=4, label="train data")
     plt.plot(grid, mean, lw=1.5, label="posterior mean")
     plt.fill_between(grid[:, 0], mean - np.sqrt(var),
                      mean + np.sqrt(var), alpha=0.25,
                      label="$\\\\pm\\\\sigma$")
     plt.legend()
     plt.title("SGHMC-trained BNN on sinc")
     plt.tight_layout()
     """),
]


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "notebooks")
    os.makedirs(out_dir, exist_ok=True)
    repo_root = os.path.join(os.path.dirname(__file__), "..")
    os.chdir(repo_root)
    for name, cells in [
        ("api_quickstart", API_QUICKSTART),
        ("Relativistic_SGHMC", RELATIVISTIC_SGHMC),
        ("SVGD", SVGD),
    ]:
        executed = run_notebook(cells)
        write_notebook(os.path.join(out_dir, name + ".ipynb"), executed)


if __name__ == "__main__":
    main()
