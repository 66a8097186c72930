"""Bayesian neural network trained with SG-MCMC, fully on device.

JAX redesign of the reference BNN
(``/root/reference/pysgmcmc/models/bayesian_neural_network.py:147-630``),
after Springenberg et al., NIPS 2016: train = sample network weights with an
SG-MCMC sampler, predict = ensemble over the collected weight snapshots.

Architectural translation:

- The reference drives one ``session.run`` per sampler step from a Python
  loop (``bayesian_neural_network.py:510-531``); here the *entire* training
  run — burn-in, minibatch selection, thinning, snapshot collection — is one
  jitted ``lax.scan`` program that never leaves XLA.
- Prediction runs one ``session.run`` per ensemble member in the reference
  (``:602-606``); here it is a single ``vmap`` over the stacked weight
  samples (``:619-628`` for the moment matching).
- The posterior ensemble is a stacked pytree on the device, not a host-side deque
  (``:290``).

Priors and likelihood match the reference exactly
(``bayesian_neural_network.py:77-141`` and ``:337-388``): heteroscedastic
Gaussian log likelihood scaled by 1/batch_size, a Gaussian prior on the log
predictive variance and an L2 weight prior, both scaled by 1/N.

Examples
--------
The priors match the reference bit-for-bit (pinned by golden tests):

>>> import jax.numpy as jnp
>>> round(float(weight_prior_log_like({"w": jnp.ones((2, 2))})), 3)
-0.5
>>> round(float(log_variance_prior_log_like(
...     jnp.full((1, 1), jnp.log(1e-6)))), 3)
2.303
"""

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np

from pysgmcmc_tpu.data_batches import batch_fn as make_batch_fn
from pysgmcmc_tpu.models.architectures import default_network
from pysgmcmc_tpu.models.base_model import (
    BaseModel,
    zero_mean_unit_var_normalization,
    zero_mean_unit_var_unnormalization,
)
from pysgmcmc_tpu.samplers.base import sample_chain
from pysgmcmc_tpu.sampling import Sampler
from pysgmcmc_tpu.stepsize_schedules import (
    ConstantStepsizeSchedule,
    StepsizeSchedule,
)
from pysgmcmc_tpu.utils.numeric import safe_divide
from pysgmcmc_tpu.utils.pytree import tree_size


# Constructor options of the removed hand-written kernel path; passing one
# raises instead of being forwarded to the sampler as an unknown keyword.
_REMOVED_OPTIONS = ("pair_dots", "noise_impl", "backend", "interpret")


def log_variance_prior_log_like(log_var, mean=1e-6, var=0.01):
    """Gaussian prior (in log space) on the predicted log variance.

    Mirrors ``bayesian_neural_network.py:77-107``:
    ``mean(sum(-(log_var - log(mean))^2 / (2 var) - 0.5 log(var), axis=1))``.
    """
    dtype = log_var.dtype
    mean = jnp.asarray(mean, dtype)
    var = jnp.asarray(var, dtype)
    return jnp.mean(
        jnp.sum(
            safe_divide(-jnp.square(log_var - jnp.log(mean)), 2.0 * var)
            - 0.5 * jnp.log(var),
            axis=1,
        )
    )


def weight_prior_log_like(params, wdecay=1.0):
    """L2 (Gaussian) prior over all parameters, normalized by their count.

    Mirrors ``bayesian_neural_network.py:110-141``.
    """
    leaves = jax.tree_util.tree_leaves(params)
    log_like = sum(jnp.sum(-wdecay * 0.5 * jnp.square(leaf)) for leaf in leaves)
    n_params = sum(leaf.size for leaf in leaves)
    return safe_divide(log_like, jnp.asarray(n_params, log_like.dtype))


class BayesianNeuralNetwork(BaseModel):
    """SG-MCMC Bayesian neural network for regression.

    Parameters (defaults match the reference ctor,
    ``bayesian_neural_network.py:148-156``):

    - ``sampling_method``: any burn-in or plain MCMC ``Sampler`` member
      (SGHMC default; SGLD and RelativisticSGHMC also supported)
    - ``batch_size`` 20, ``stepsize_schedule`` constant ``sqrt(1e-4)``
    - ``n_nets`` 100 posterior snapshots, thinned every ``sample_steps`` 100
    - ``n_iters`` 50000 total iteration budget, ``burn_in_steps`` 1000
    - ``normalize_input`` / ``normalize_output`` True
    - extra ``**sampler_kwargs`` forwarded to the sampler constructor

    The network is an ``(init, apply)`` pair (see
    :func:`pysgmcmc_tpu.models.architectures.default_network`); pass
    ``get_net=(init_fn, apply_fn)`` to swap architectures.

    New relative to the reference: ``n_chains > 1`` trains that many
    independent chains in parallel (each with its own He-normal init and
    burn-in) and pools ``n_nets`` snapshots across them — better posterior
    coverage at the same wall-clock; pass ``mesh`` (a
    :func:`pysgmcmc_tpu.parallel.mesh.chain_mesh`) to shard chains over
    devices.

    ``step_impl`` picks the training driver: ``'pytree'`` (default) runs
    the samplers' own ``step`` under ``vmap``/``scan``; ``'lanes'`` runs
    both phases on the packed chains-on-lanes drivers of
    :mod:`pysgmcmc_tpu.parallel.packed`.
    """

    def __init__(
        self,
        sampling_method=Sampler.SGHMC,
        get_net=None,
        batch_size=20,
        stepsize_schedule=None,
        n_nets=100,
        n_iters=50000,
        burn_in_steps=1000,
        sample_steps=100,
        normalize_input=True,
        normalize_output=True,
        seed=0,
        dtype=jnp.float32,
        compute_dtype=None,
        n_chains=1,
        mesh=None,
        log_every=512,
        network="reference",
        step_impl="pytree",
        units=(50, 50, 50),
        **sampler_kwargs,
    ):
        super().__init__()
        removed = sorted(set(sampler_kwargs) & set(_REMOVED_OPTIONS))
        if step_impl == "fused":
            removed.insert(0, "step_impl='fused'")
        if removed:
            raise ValueError(
                "BayesianNeuralNetwork: {} {} removed together with the "
                "hand-written kernel path; use step_impl='pytree' (default) "
                "or 'lanes'".format(
                    ", ".join(removed), "was" if len(removed) == 1 else "were")
            )
        if not isinstance(n_nets, int) or n_nets <= 0:
            raise ValueError("n_nets must be a positive integer")
        if not isinstance(n_iters, int) or n_iters <= 0:
            raise ValueError("n_iters must be a positive integer")
        if not isinstance(burn_in_steps, int) or burn_in_steps < 0:
            raise ValueError("burn_in_steps must be a non-negative integer")
        if not isinstance(sample_steps, int) or sample_steps <= 0:
            raise ValueError("sample_steps must be a positive integer")
        if not isinstance(batch_size, int) or batch_size <= 0:
            raise ValueError("batch_size must be a positive integer")
        if not Sampler.is_supported(sampling_method):
            raise ValueError(
                "BayesianNeuralNetwork received unsupported input for "
                "parameter 'sampling_method'. Input was: {!r}.\n"
                "Supported sampling methods are enumerated in the "
                "'Sampler' enum type.".format(sampling_method)
            )
        if stepsize_schedule is None:
            stepsize_schedule = ConstantStepsizeSchedule(float(np.sqrt(1e-4)))
        if not isinstance(stepsize_schedule, StepsizeSchedule):
            stepsize_schedule = ConstantStepsizeSchedule(float(stepsize_schedule))

        self.sampling_method = sampling_method
        self.get_net = get_net
        self.batch_size = batch_size
        self.stepsize_schedule = stepsize_schedule
        self.n_nets = n_nets
        self.n_iters = n_iters
        self.burn_in_steps = burn_in_steps
        self.sample_steps = sample_steps
        self.normalize_input = normalize_input
        self.normalize_output = normalize_output
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        self.seed = seed
        if not isinstance(n_chains, int) or n_chains <= 0:
            raise ValueError("n_chains must be a positive integer")
        if n_chains > 1 and n_nets % n_chains != 0:
            raise ValueError(
                "n_nets ({}) must be divisible by n_chains ({})".format(
                    n_nets, n_chains
                )
            )
        self.n_chains = n_chains
        self.mesh = mesh
        # In-training telemetry (reference parity,
        # ``bayesian_neural_network.py:472-519``): full-training-set NLL/MSE
        # is logged every ``log_every`` burn-in iterations and at every
        # collected sample.  The training scan is chunked at log boundaries
        # (an outer Python loop over identically-shaped compiled segments, so
        # compilation happens once per segment shape).  ``log_every=None``
        # recovers the single-scan program; chunking re-keys the PRNG per
        # segment, so the two settings draw different (equally valid) chains.
        if log_every is not None and (
            not isinstance(log_every, int) or log_every <= 0
        ):
            raise ValueError("log_every must be a positive integer or None")
        self.log_every = log_every
        # network="dense": the same architecture with packed parameter
        # shapes (models/architectures.dense_network — identical math and
        # init draws).  step_impl="lanes": run both phases on the packed
        # chains-on-lanes drivers (any sampler in the gradient-based
        # family, any architecture; parallel/packed).
        if network not in ("reference", "dense"):
            raise ValueError("network must be 'reference' or 'dense'")
        if step_impl not in ("pytree", "lanes"):
            raise ValueError("step_impl must be 'pytree' or 'lanes'")
        if step_impl == "lanes":
            # Composes with ``mesh`` — the drivers shard_map the chain axis.
            lanes_ok = (
                Sampler.SGHMC, Sampler.SGLD, Sampler.PSGLD,
                Sampler.RelativisticSGHMC, Sampler.SGNHT,
            )
            if sampling_method not in lanes_ok:
                raise ValueError(
                    "step_impl='lanes' supports SGHMC, SGLD, PSGLD, "
                    "RelativisticSGHMC and SGNHT")
        units = tuple(int(u) for u in units)
        if not units or any(u <= 0 for u in units):
            raise ValueError("units must be positive layer widths")
        self.units = units
        self.network = network
        self.step_impl = step_impl
        # Mixed precision: run the network's matmuls in ``compute_dtype``
        # (e.g. bfloat16) while the sampler state, priors, and likelihood
        # arithmetic stay in ``dtype``.  The bf16 rounding perturbation on the minibatch
        # gradient is far below SG-MCMC's injected sampling noise.
        self.compute_dtype = compute_dtype
        self.dtype = dtype
        self.sampler_kwargs = sampler_kwargs

        self.samples = None  # stacked pytree, leading axis n_nets
        self.is_trained = False
        self._serving_fns = {}  # predict(compute_dtype=...) jit cache

    #  Likelihood ------------------------------------------------------------

    def negative_log_likelihood(self, apply_fn, params, x, y, n_examples):
        """NLL and MSE of ``params`` on minibatch ``(x, y)``.

        Mirrors ``bayesian_neural_network.py:337-388`` term by term.
        Returns ``(nll, mse)``.  With ``compute_dtype`` set, the network
        forward (and therefore its backward matmuls) run in that dtype;
        likelihood arithmetic and priors stay in ``dtype``.
        """
        if self.compute_dtype is not None:
            from pysgmcmc_tpu.utils.pytree import tree_cast

            net_out = apply_fn(
                tree_cast(params, self.compute_dtype),
                jnp.asarray(x, self.compute_dtype),
            ).astype(self.dtype)
        else:
            net_out = apply_fn(params, x)
        f_mean = net_out[:, 0:1]
        f_log_var = net_out[:, 1:2]

        f_var_inv = 1.0 / (jnp.exp(f_log_var) + 1e-16)
        mse = jnp.square(y - f_mean)
        log_like = jnp.sum(
            jnp.sum(-mse * (0.5 * f_var_inv) - 0.5 * f_log_var, axis=1)
        )
        log_like = log_like / jnp.asarray(self.batch_size, self.dtype)

        n = jnp.asarray(n_examples, self.dtype)
        log_like += log_variance_prior_log_like(f_log_var) / n
        log_like += weight_prior_log_like(params) / n
        return -log_like, jnp.mean(mse)

    #  Training ---------------------------------------------------------------

    def _build_sampler(self, cost_fn, n_datapoints):
        kwargs = dict(self.sampler_kwargs)
        kwargs.update(
            cost_fn=cost_fn,
            stepsize_schedule=self.stepsize_schedule,
            dtype=self.dtype,
        )
        if Sampler.is_burn_in_mcmc(self.sampling_method):
            kwargs.setdefault("scale_grad", float(n_datapoints))
            kwargs.setdefault("burn_in_steps", self.burn_in_steps)
        elif self.sampling_method in (Sampler.PSGLD, Sampler.SGNHT):
            kwargs.setdefault("scale_grad", float(n_datapoints))
        return Sampler.get_sampler(self.sampling_method, **kwargs)

    def _n_collect(self, target=None):
        target = self.n_nets if target is None else target
        budget = max(0, (self.n_iters - self.burn_in_steps) // self.sample_steps)
        n_collect = min(target, budget)
        if n_collect < target:
            logging.warning(
                "BayesianNeuralNetwork: iteration budget n_iters=%d only "
                "allows %d of the requested %d posterior samples",
                self.n_iters, n_collect, self.n_nets,
            )
        if n_collect == 0:
            raise ValueError(
                "BayesianNeuralNetwork: n_iters={} is too small to collect "
                "any samples (burn_in_steps={}, sample_steps={})".format(
                    self.n_iters, self.burn_in_steps, self.sample_steps
                )
            )
        return n_collect

    @BaseModel._check_shapes_train
    def train(self, X, y, *args, **kwargs):
        """Sample ``n_nets`` network-weight snapshots from the posterior.

        The whole run (burn-in + thinned collection, minibatching included)
        executes as one compiled scan — the replacement for the
        reference's per-step ``session.run`` loop
        (``bayesian_neural_network.py:510-531``).
        """
        start_time = time.time()
        self.X, self.y = X, y

        x_train = np.asarray(X, dtype=np.float64)
        y_train = np.asarray(y, dtype=np.float64)
        if self.normalize_input:
            x_train, self.x_mean, self.x_std = zero_mean_unit_var_normalization(
                x_train
            )
        if self.normalize_output:
            y_train, self.y_mean, self.y_std = zero_mean_unit_var_normalization(
                y_train
            )

        n_datapoints, n_inputs = x_train.shape
        x_dev = jnp.asarray(x_train, self.dtype)
        y_dev = jnp.asarray(y_train, self.dtype)

        if self.get_net is None:
            if self.network == "dense":
                from pysgmcmc_tpu.models.architectures import dense_network

                init_fn, apply_fn = dense_network(
                    n_inputs, units=self.units, dtype=self.dtype)
            else:
                init_fn, apply_fn = default_network(
                    n_inputs, units=self.units, dtype=self.dtype)
        else:
            init_fn, apply_fn = self.get_net
        self._apply_fn = apply_fn
        # jitted ensemble forward for predict() — an eager vmap would
        # dispatch op-by-op
        self._ensemble_fn = jax.jit(
            jax.vmap(apply_fn, in_axes=(0, None))
        )
        # serving fast paths (predict(compute_dtype=...)) are rebuilt lazily
        # against the trained architecture — drop any stale ones
        self._n_inputs = n_inputs
        self._serving_fns = {}

        def cost_fn(params, batch):
            x_batch, y_batch = batch
            nll, _ = self.negative_log_likelihood(
                apply_fn, params, x_batch, y_batch, n_datapoints
            )
            return nll

        select_batch = make_batch_fn(x_dev, y_dev, self.batch_size)
        key = jax.random.PRNGKey(self.seed)
        key_net, key_init, key_burn, key_sample = jax.random.split(key, 4)

        if self.sampling_method == Sampler.SVGD:
            # SVGD trains the whole ensemble at once: n_nets particles, each
            # a full network, transported jointly.  This is the ensemble
            # interface the reference wished for but never built
            # (``samplers/svgd.py:7-10`` XXX).
            self._train_svgd(
                cost_fn, init_fn, key_net, key_sample, select_batch
            )
            self.is_trained = True
            logging.info(
                "BayesianNeuralNetwork(SVGD): transported %d particles in "
                "%.2fs", self.n_nets, time.time() - start_time,
            )
            return

        if self.step_impl == "lanes":
            self._train_lanes(
                cost_fn, init_fn, select_batch, n_datapoints,
                key_net, key_init, key_burn, key_sample, start_time,
                apply_fn, x_dev, y_dev,
            )
            return

        sampler = self._build_sampler(cost_fn, n_datapoints)

        if self.log_every is not None:
            self._train_chunked(
                sampler, init_fn, apply_fn, select_batch,
                key_net, key_init, key_burn, key_sample,
                x_dev, y_dev, n_datapoints, start_time,
            )
            return

        if self.n_chains > 1:
            # Parallel-chain training: each chain burns in and collects its
            # share of the ensemble; chains vmap (and optionally shard over
            # a device mesh).  New capability — the reference trains one
            # chain in a Python loop.
            per_chain = self._n_collect(self.n_nets // self.n_chains)

            def one_chain(position, chain_key):
                k_init, k_burn, k_sample = jax.random.split(chain_key, 3)
                state = sampler.init(position, k_init)
                # The scan is split at the burn-in boundary so each side is
                # statically specialized (the sampling scan drops the frozen
                # adaptation stats from its per-step HBM traffic).
                if self.burn_in_steps > 0:
                    state, _ = sample_chain(
                        sampler, state, k_burn, 1,
                        batch_fn=select_batch,
                        keep_every=self.burn_in_steps,
                        collect_costs=False,
                        phase="burn_in",
                    )
                state, samples, costs = sample_chain(
                    sampler, state, k_sample, per_chain,
                    batch_fn=select_batch,
                    keep_every=self.sample_steps,
                    phase="sampling",
                )
                return samples, costs

            chain_keys = jax.random.split(key_sample, self.n_chains)
            init_keys = jax.random.split(key_net, self.n_chains)
            positions = jax.vmap(init_fn)(init_keys)

            vmapped = jax.vmap(one_chain)
            if self.mesh is not None:
                from jax.sharding import PartitionSpec

                from pysgmcmc_tpu.parallel.mesh import CHAIN_AXIS, shard_chains

                if self.n_chains % self.mesh.devices.size != 0:
                    raise ValueError(
                        "n_chains must be divisible by the mesh size"
                    )
                positions = shard_chains(positions, self.mesh)
                spec = PartitionSpec(CHAIN_AXIS)
                vmapped = jax.shard_map(
                    vmapped, mesh=self.mesh, in_specs=spec, out_specs=spec
                )

            samples, costs = jax.jit(vmapped)(positions, chain_keys)
            self.samples = self._pool_chains(samples)
            self._n_collected = self.n_chains * per_chain
            self.is_trained = True
            logging.info(
                "BayesianNeuralNetwork: %d chains x %d samples in %.2fs",
                self.n_chains, per_chain, time.time() - start_time,
            )
            return

        n_collect = self._n_collect()
        params0 = init_fn(key_net)

        @jax.jit
        def run(params0):
            state = sampler.init(params0, key_init)
            if self.burn_in_steps > 0:
                state, _ = sample_chain(
                    sampler, state, key_burn, 1,
                    batch_fn=select_batch,
                    keep_every=self.burn_in_steps,
                    collect_costs=False,
                    phase="burn_in",
                )
            state, samples, costs = sample_chain(
                sampler, state, key_sample, n_collect,
                batch_fn=select_batch,
                keep_every=self.sample_steps,
                phase="sampling",
            )
            return samples, costs

        self.samples, costs = run(params0)
        self._n_collected = n_collect
        self.is_trained = True
        logging.info(
            "BayesianNeuralNetwork: collected %d samples in %.2fs "
            "(final minibatch NLL %.4e)",
            n_collect, time.time() - start_time, float(np.asarray(costs)[-1]),
        )

    def _train_lanes(
        self, cost_fn, init_fn, select_batch, n_datapoints,
        key_net, key_init, key_burn, key_sample, start_time,
        apply_fn, x_dev, y_dev,
    ):
        """Training with the chains-on-lanes packed drivers, end to end.

        BOTH phases run on the packed chains-on-lanes path: burn-in via
        :func:`pysgmcmc_tpu.parallel.packed.burnin_chain_lanes` (the
        EMA-adaptation update, for the adaptive SGHMC/SGLD; the
        non-adaptive PSGLD/RSGHMC/SGNHT discard early lanes-driver samples
        instead) and sampling via
        :func:`pysgmcmc_tpu.parallel.packed.sample_chain_lanes` — for any
        architecture/cost function and all five gradient-based samplers.
        Composes with ``mesh`` (the drivers shard_map over the chain
        axis).

        Telemetry matches the reference's training logs
        (``bayesian_neural_network.py:472-519``): full-training-set
        NLL/MSE at iteration 0, every ``log_every`` burn-in iterations,
        and at every collected sample, via chunked driver segments (one
        compile per segment shape).  ``log_every=None`` recovers the
        single-segment program.
        """
        from pysgmcmc_tpu.parallel.packed import (
            burnin_chain_lanes,
            sample_chain_lanes,
        )

        n_chains = max(1, self.n_chains)
        per_chain = self._n_collect(
            self.n_nets // n_chains if self.n_chains > 1 else None
        )
        sampler = self._build_sampler(cost_fn, n_datapoints)
        positions = jax.vmap(init_fn)(jax.random.split(key_net, n_chains))

        state_dtype = (
            jnp.bfloat16 if self.compute_dtype is not None else jnp.float32
        )
        adaptive = Sampler.is_burn_in_mcmc(self.sampling_method)
        mesh = self.mesh

        states = jax.jit(jax.vmap(sampler.init))(
            positions, jax.random.split(key_init, n_chains)
        )

        metric = lambda pos: self.negative_log_likelihood(  # noqa: E731
            apply_fn, pos, x_dev, y_dev, n_datapoints
        )
        metrics_fn = jax.jit(jax.vmap(metric))

        def log_point(iteration, positions_now, n_samples=None):
            if self.log_every is None or not logging.getLogger(
            ).isEnabledFor(logging.INFO):
                return
            nll, mse = metrics_fn(positions_now)
            suffix = "" if n_samples is None else " Samples = {}".format(
                n_samples)
            logging.info(
                "Iter %8d : NLL = %.4e MSE = %.4e%s Time = %5.2f",
                iteration, float(jnp.mean(nll)), float(jnp.mean(mse)),
                suffix, time.time() - start_time,
            )

        def make_burn(n_steps):
            if adaptive:
                return jax.jit(lambda s, k: burnin_chain_lanes(
                    sampler, s, k, n_steps, batch_fn=select_batch,
                    compute_dtype=self.compute_dtype,
                    state_dtype=jnp.float32, mesh=mesh,
                ))
            # PSGLD adapts continuously / RSGHMC has no burn-in machinery:
            # "burn-in" is simply discarded lanes-driver steps
            return jax.jit(lambda s, k: sample_chain_lanes(
                sampler, s, k, 1, batch_fn=select_batch,
                keep_every=n_steps, compute_dtype=self.compute_dtype,
                state_dtype=state_dtype, collect_positions=False, mesh=mesh,
            )[0])

        # telemetry chunks the burn-in at log boundaries; telemetry off
        # runs one segment
        if self.log_every is not None and self.burn_in_steps > 0:
            n_full, rem = divmod(self.burn_in_steps, self.log_every)
            seg_lengths = [self.log_every] * n_full + ([rem] if rem else [])
        else:
            seg_lengths = (
                [self.burn_in_steps] if self.burn_in_steps > 0 else [])
        burn_fns = {n: make_burn(n) for n in set(seg_lengths)}

        log_point(0, states.position)
        iteration = 0
        burn_keys = jax.random.split(key_burn, max(1, len(seg_lengths)))
        for i, n_steps in enumerate(seg_lengths):
            states = burn_fns[n_steps](states, burn_keys[i])
            iteration += n_steps
            log_point(iteration, states.position)

        def sample_seg(states, key, n_keep):
            return sample_chain_lanes(
                sampler, states, key, n_keep, batch_fn=select_batch,
                keep_every=self.sample_steps,
                compute_dtype=self.compute_dtype,
                state_dtype=state_dtype, mesh=mesh,
            )
        sample_seg = jax.jit(sample_seg, static_argnums=2)

        if self.log_every is not None:
            sample_keys = jax.random.split(key_sample, per_chain)
            pos_chunks = []
            for j in range(per_chain):
                states, pos, _ = sample_seg(states, sample_keys[j], 1)
                pos_chunks.append(pos)
                iteration += self.sample_steps
                log_point(iteration, states.position,
                          n_samples=(j + 1) * n_chains)
            samples = jax.tree_util.tree_map(
                lambda *leaves: jnp.concatenate(leaves, axis=1), *pos_chunks
            )
        else:
            _, samples, _ = sample_seg(states, key_sample, per_chain)

        self.samples = self._pool_chains(samples)
        self._n_collected = n_chains * per_chain
        self.is_trained = True
        logging.info(
            "BayesianNeuralNetwork(lanes): %d chains x %d samples in %.2fs",
            n_chains, per_chain, time.time() - start_time,
        )

    def _train_chunked(
        self, sampler, init_fn, apply_fn, select_batch,
        key_net, key_init, key_burn, key_sample,
        x_dev, y_dev, n_datapoints, start_time,
    ):
        """Chunked training run with in-training telemetry.

        Reference parity for the training logs
        (``bayesian_neural_network.py:472-519``): the full-training-set
        NLL/MSE is logged at iteration 0, every ``log_every`` burn-in
        iterations, and at every collected sample.  The run is an outer
        Python loop over identically-shaped compiled scan segments — one
        compile per segment shape, so the telemetry costs only the segment
        dispatches plus one jitted full-data forward per log point (and the
        forward is skipped entirely unless INFO logging is enabled).

        The reference's log line swaps its ``Samples =`` field between the
        two phases (``:497-508`` logs the sample count during burn-in, when
        it is always zero); here the count is logged during sampling.
        """
        multi = self.n_chains > 1
        n_collect = self._n_collect(
            self.n_nets // self.n_chains if multi else None
        )

        if multi:
            positions = jax.vmap(init_fn)(
                jax.random.split(key_net, self.n_chains)
            )
            init_keys = jax.random.split(key_init, self.n_chains)
        else:
            positions = init_fn(key_net)
            init_keys = key_init

        def wrap(fn):
            """vmap over chains (multi) and shard over the mesh if given."""
            if not multi:
                return jax.jit(fn)
            vm = jax.vmap(fn)
            if self.mesh is not None:
                from jax.sharding import PartitionSpec

                from pysgmcmc_tpu.parallel.mesh import CHAIN_AXIS, shard_chains

                if self.n_chains % self.mesh.devices.size != 0:
                    raise ValueError(
                        "n_chains must be divisible by the mesh size"
                    )
                spec = PartitionSpec(CHAIN_AXIS)
                vm = jax.shard_map(
                    vm, mesh=self.mesh, in_specs=spec, out_specs=spec
                )
            return jax.jit(vm)

        if multi and self.mesh is not None:
            from pysgmcmc_tpu.parallel.mesh import shard_chains

            positions = shard_chains(positions, self.mesh)

        state = wrap(sampler.init)(positions, init_keys)

        # Burn-in segment plan: full log_every segments plus a remainder.
        n_full, rem = divmod(self.burn_in_steps, self.log_every)
        seg_lengths = [self.log_every] * n_full + ([rem] if rem else [])

        def make_advance(n_steps):
            def advance(state, key):
                state, _ = sample_chain(
                    sampler, state, key, 1, batch_fn=select_batch,
                    keep_every=n_steps, collect_costs=False, phase="burn_in",
                )
                return state
            return wrap(advance)

        advance_fns = {n: make_advance(n) for n in set(seg_lengths)}

        def collect(state, key):
            return sample_chain(
                sampler, state, key, 1, batch_fn=select_batch,
                keep_every=self.sample_steps, phase="sampling",
            )
        collect_fn = wrap(collect)

        # Per-segment keys, derived in one jitted call each.
        n_segments = len(seg_lengths)

        def make_keys(key, n):
            if multi:
                return jax.vmap(lambda c: jax.random.split(c, n))(
                    jax.random.split(key, self.n_chains)
                )  # (n_chains, n, 2); index [:, i]
            return jax.random.split(key, n)

        burn_keys = (
            jax.jit(make_keys, static_argnums=1)(key_burn, n_segments)
            if n_segments else None
        )
        sample_keys = jax.jit(make_keys, static_argnums=1)(
            key_sample, n_collect
        )

        metric = lambda pos: self.negative_log_likelihood(  # noqa: E731
            apply_fn, pos, x_dev, y_dev, n_datapoints
        )
        metrics_fn = jax.jit(jax.vmap(metric) if multi else metric)

        def log_point(iteration, state, n_samples=None):
            if not logging.getLogger().isEnabledFor(logging.INFO):
                return
            nll, mse = metrics_fn(sampler.position(state))
            nll = float(jnp.mean(nll)) if multi else float(nll)
            mse = float(jnp.mean(mse)) if multi else float(mse)
            suffix = "" if n_samples is None else " Samples = {}".format(
                n_samples
            )
            logging.info(
                "Iter %8d : NLL = %.4e MSE = %.4e%s Time = %5.2f",
                iteration, nll, mse, suffix, time.time() - start_time,
            )

        log_point(0, state)
        iteration = 0
        for i, n_steps in enumerate(seg_lengths):
            k = burn_keys[:, i] if multi else burn_keys[i]
            state = advance_fns[n_steps](state, k)
            iteration += n_steps
            log_point(iteration, state)

        pos_chunks, cost_chunks = [], []
        for j in range(n_collect):
            k = sample_keys[:, j] if multi else sample_keys[j]
            state, pos, cost = collect_fn(state, k)
            pos_chunks.append(pos)
            cost_chunks.append(cost)
            iteration += self.sample_steps
            log_point(iteration, state, n_samples=(j + 1) * self.n_chains)

        axis = 1 if multi else 0  # the length-1 collected axis
        samples = jax.tree_util.tree_map(
            lambda *leaves: jnp.concatenate(leaves, axis=axis), *pos_chunks
        )
        self.samples = self._pool_chains(samples) if multi else samples
        self._n_collected = n_collect * self.n_chains
        self.is_trained = True
        logging.info(
            "BayesianNeuralNetwork: collected %d samples in %.2fs",
            self._n_collected, time.time() - start_time,
        )

    def _pool_chains(self, samples):
        """``(n_chains, per_chain, ...)`` -> ``(n_chains * per_chain, ...)``.

        Under a mesh the merged axis keeps the chain-axis sharding; it is
        given explicitly because JAX cannot infer the sharding of every
        such merge (e.g. leaves with a size-1 axis).
        """
        sharding = None
        if self.mesh is not None:
            from pysgmcmc_tpu.parallel.mesh import (
                chain_sharding,
                mesh_chain_axes,
            )

            sharding = chain_sharding(self.mesh, mesh_chain_axes(self.mesh))
        return jax.tree_util.tree_map(
            lambda leaf: jax.lax.reshape(
                leaf, (leaf.shape[0] * leaf.shape[1],) + leaf.shape[2:],
                out_sharding=sharding,
            ),
            samples,
        )

    def _train_svgd(self, cost_fn, init_fn, key_net, key_run, select_batch):
        """Train ``n_nets`` particle networks jointly with SVGD."""
        from pysgmcmc_tpu.samplers.svgd import SVGDSampler

        kwargs = dict(self.sampler_kwargs)
        kwargs.update(
            cost_fn=cost_fn,
            stepsize_schedule=self.stepsize_schedule,
            dtype=self.dtype,
        )
        sampler = Sampler.get_sampler(Sampler.SVGD, **kwargs)
        assert isinstance(sampler, SVGDSampler)

        particle_keys = jax.random.split(key_net, self.n_nets)
        particles = jax.vmap(init_fn)(particle_keys)
        state = sampler.init(particles)

        @jax.jit
        def run(state, key):
            def body(carry, _):
                state, key = carry
                key, key_step, key_batch = jax.random.split(key, 3)
                batch = select_batch(key_batch)
                state, info = sampler.step(state, key_step, batch)
                return (state, key), ()

            (state, _), _ = jax.lax.scan(
                body, (state, key), None, length=self.n_iters
            )
            return state

        state = run(state, key_run)
        self.samples = state.position
        self._n_collected = self.n_nets

    #  Prediction -------------------------------------------------------------

    def compute_network_output(self, params, input_data):
        """Forward pass of one weight sample (cf. ``:535-557``)."""
        return self._apply_fn(params, jnp.asarray(input_data, self.dtype))

    def _serving_fn(self, compute_dtype):
        """Jitted ensemble forward in ``compute_dtype`` (serving fast path).

        Rebuilds the trained built-in architecture at the requested compute
        precision and casts the posterior-sample pytree per call (the cast is
        ~E x n_params elements — negligible against the batched forward).
        The predictive mean/variance reduction stays in float32: outputs are
        upcast in-device before leaving the jit.
        """
        key = jnp.dtype(compute_dtype).name
        if key not in self._serving_fns:
            if self.get_net is not None:
                raise ValueError(
                    "predict(compute_dtype=...) supports the built-in "
                    "architectures only (get_net is custom; its apply "
                    "closes over its own precision)"
                )
            if self.network == "dense":
                from pysgmcmc_tpu.models.architectures import dense_network

                _, apply_cd = dense_network(
                    self._n_inputs, units=self.units, dtype=compute_dtype)
            else:
                _, apply_cd = default_network(
                    self._n_inputs, units=self.units, dtype=compute_dtype)

            def ensemble(samples, x):
                cast = jax.tree_util.tree_map(
                    lambda leaf: leaf.astype(compute_dtype), samples
                )
                out = jax.vmap(apply_cd, in_axes=(0, None))(cast, x)
                return out.astype(jnp.float32)

            self._serving_fns[key] = jax.jit(ensemble)
        return self._serving_fns[key]

    @BaseModel._check_shapes_predict
    def predict(self, X_test, return_individual_predictions=False,
                compute_dtype=None, *args, **kwargs):
        """Ensemble predictive mean and variance at ``X_test``.

        One ``vmap`` over the stacked posterior samples replaces the
        reference's per-member ``session.run`` loop (``:602-606``).

        ``compute_dtype`` selects a serving path at another precision: the
        ensemble forward runs at that precision (e.g. ``jnp.bfloat16``,
        half the activation traffic) while the mean/variance reduction
        stays in float32.  Default ``None`` keeps the model's training
        precision end to end.
        """
        if not self.is_trained:
            raise ValueError(
                "Calling `bnn.predict()` on an untrained Bayesian Neural "
                "Network 'bnn' is not supported! Please call `bnn.train()` "
                "before calling `bnn.predict()`"
            )

        x_test = np.asarray(X_test, dtype=np.float64)
        if self.normalize_input:
            x_test, _, _ = zero_mean_unit_var_normalization(
                x_test, self.x_mean, self.x_std
            )

        if compute_dtype is not None and (
            jnp.dtype(compute_dtype) != jnp.dtype(self.dtype)
        ):
            ensemble_fn = self._serving_fn(compute_dtype)
            x_dev = jnp.asarray(x_test, compute_dtype)
        else:
            ensemble_fn = self._ensemble_fn
            x_dev = jnp.asarray(x_test, self.dtype)

        outputs = ensemble_fn(self.samples, x_dev)
        f_out = np.asarray(outputs[:, :, 0])
        theta_noise = np.exp(np.asarray(outputs[:, :, 1]))

        if return_individual_predictions:
            if self.normalize_output:
                f_out = zero_mean_unit_var_unnormalization(
                    f_out, self.y_mean, self.y_std
                )
                theta_noise *= self.y_std**2
            return f_out, theta_noise

        mean_prediction = np.mean(f_out, axis=0)
        variance_prediction = np.mean((f_out - mean_prediction) ** 2, axis=0)

        if self.normalize_output:
            mean_prediction = zero_mean_unit_var_unnormalization(
                mean_prediction, self.y_mean, self.y_std
            )
            variance_prediction *= self.y_std**2
        return mean_prediction, variance_prediction
