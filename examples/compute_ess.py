"""ESS-vs-stepsize experiment runner.

Counterpart of the reference's experiment CLI
(``/root/reference/docs/source/experiments/compute_ess.py:30-133``): for a
benchmark density and a sweep of stepsizes, run ``n_chains`` chains of a
sampler and record per-stepsize mean effective sample sizes.  The reference
runs the 20 chains of every stepsize sequentially; here the *entire sweep*
is parallel — chains AND stepsizes batch into one device program (stepsizes
loop host-side, chains vmap; a mesh shards the chain axis).

Usage::

    python examples/compute_ess.py banana --sampler RelativisticSGHMC \
        --stepsize-min 0.01 --stepsize-max 4.01 --stepsize-increment 0.05 \
        -o ess_banana.json

Output JSON schema matches the reference notebook data
(``docs/source/notebooks/data/effective_sample_sizes/Relativistic_SGHMC.json``):
``{benchmark: {stepsize: [per-variable ESS ...]}}``.
"""

import argparse
import json
from collections import namedtuple

import numpy as np


def main():
    parser = argparse.ArgumentParser(
        description="Study the relationship between sampler stepsize and "
        "effective sample size (ESS) on four benchmark densities."
    )
    parser.add_argument(
        "benchmark", help="One of: 'banana', 'gmm1', 'gmm2', 'gmm3'."
    )
    parser.add_argument("--sampler", default="RelativisticSGHMC")
    parser.add_argument("--n-chains", type=int, default=20)
    parser.add_argument("--samples-per-chain", type=int, default=10**4)
    parser.add_argument("--keep-every", type=int, default=10)
    parser.add_argument("--stepsize-min", type=float, default=0.01)
    parser.add_argument("--stepsize-max", type=float, default=8.0)
    parser.add_argument("--stepsize-increment", type=float, default=0.05,
                        dest="stepsize_step")
    parser.add_argument("--stepsize", type=float, default=None,
                        help="Single stepsize (overrides the range).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mesh", action="store_true",
                        help="Shard the chain axis over all local devices.")
    parser.add_argument("-o", "--output-file", dest="output_filename",
                        default="output.json")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from pysgmcmc_tpu.diagnostics.objective_functions import (
        banana_log_likelihood,
        gmm1_log_likelihood,
        gmm2_log_likelihood,
        gmm3_log_likelihood,
        to_negative_log_likelihood,
    )
    from pysgmcmc_tpu.diagnostics.sampler_diagnostics import (
        effective_sample_size,
    )
    from pysgmcmc_tpu.parallel.chains import run_chains, stack_positions
    from pysgmcmc_tpu.parallel.mesh import chain_mesh
    from pysgmcmc_tpu.sampling import Sampler

    ObjectiveFunction = namedtuple("ObjectiveFunction", ["function", "dimensionality"])
    benchmarks = {
        "banana": ObjectiveFunction(banana_log_likelihood, 2),
        "gmm1": ObjectiveFunction(gmm1_log_likelihood, 1),
        "gmm2": ObjectiveFunction(gmm2_log_likelihood, 1),
        "gmm3": ObjectiveFunction(gmm3_log_likelihood, 1),
    }
    if args.benchmark not in benchmarks:
        raise SystemExit(
            "unknown benchmark {!r}; choose from {}".format(
                args.benchmark, sorted(benchmarks)
            )
        )
    objective = benchmarks[args.benchmark]
    cost_fn = to_negative_log_likelihood(objective.function)

    if args.stepsize is not None:
        stepsizes = [args.stepsize]
    else:
        stepsizes = list(
            np.arange(args.stepsize_min, args.stepsize_max, args.stepsize_step)
        )

    mesh = chain_mesh() if args.mesh else None
    key = jax.random.PRNGKey(args.seed)
    results = {}
    for stepsize in stepsizes:
        sampler = Sampler.get_sampler(
            Sampler[args.sampler], cost_fn=cost_fn,
            stepsize_schedule=float(stepsize),
        )
        key, key_jitter, key_run = jax.random.split(key, 3)
        positions = stack_positions(
            jnp.zeros(objective.dimensionality), args.n_chains,
            jitter=1.0, key=key_jitter,
        )
        chains, _ = run_chains(
            sampler, positions, key_run, args.samples_per_chain,
            keep_every=args.keep_every, mesh=mesh,
        )
        ess = np.atleast_1d(np.asarray(effective_sample_size(chains)))
        results[float(stepsize)] = ess.tolist()
        print(
            "stepsize {:.4f}: mean ESS {:.1f}".format(stepsize, ess.mean()),
            flush=True,
        )

    with open(args.output_filename, "w") as handle:
        json.dump({args.benchmark: results}, handle, indent=2)
    print("wrote", args.output_filename)


if __name__ == "__main__":
    main()
