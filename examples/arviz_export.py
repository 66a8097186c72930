"""Export a posterior to the ArviZ / InferenceData ecosystem.

Modern counterpart of the reference's pymc3 interop (its traces duck-type
pymc3 and return a real ``pymc3.backends.base.MultiTrace``,
``/root/reference/pysgmcmc/diagnostics/sample_chains.py:338-384``): run a
few SGHMC chains on the gmm1 mixture, convert with
:func:`pysgmcmc_tpu.diagnostics.to_arviz`, and hand the result to arviz's
own diagnostics.  When arviz is not installed (it is optional), the same
posterior is exported with :func:`to_inference_dict` — identical
``(chain, draw, *shape)`` arrays, no dependencies — and summarized with
the framework's native ESS/PSRF instead.

Run: ``PYTHONPATH=. JAX_PLATFORMS=cpu python examples/arviz_export.py``
"""

import jax
import jax.numpy as jnp
import numpy as np

from pysgmcmc_tpu.diagnostics import (
    effective_sample_size,
    gelman_rubin,
    to_arviz,
    to_inference_dict,
)
from pysgmcmc_tpu.diagnostics.objective_functions import (
    gmm1_log_likelihood,
    to_negative_log_likelihood,
)
from pysgmcmc_tpu.parallel.chains import run_chains
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler


def main():
    n_chains, n_draws = 4, 2000
    sampler = SGHMCSampler(
        to_negative_log_likelihood(gmm1_log_likelihood),
        stepsize_schedule=0.05, burn_in_steps=1000)
    positions = jnp.linspace(-4.0, 4.0, n_chains).reshape(n_chains, 1)
    chains, costs = run_chains(
        sampler, positions, jax.random.PRNGKey(0), n_draws, keep_every=5)

    try:
        import arviz

        idata = to_arviz(chains, costs=costs, attrs={"sampler": "SGHMC"})
        print(idata)
        print(arviz.summary(idata))
        print("arviz ess:", float(np.asarray(arviz.ess(idata)["x"])))
    except ImportError:
        d = to_inference_dict(chains, costs=costs,
                              attrs={"sampler": "SGHMC"})
        x = d["posterior"]["x"]  # (chain, draw, 1)
        print("arviz not installed; to_inference_dict layout:",
              {k: {n: a.shape for n, a in v.items()}
               for k, v in d.items() if k in ("posterior", "sample_stats")})
        ess = float(effective_sample_size(jnp.asarray(x[:, :, 0])))
        psrf = float(gelman_rubin(jnp.asarray(x[:, :, 0])))
        print("native ESS=%.1f PSRF=%.3f mean lp=%.3f" % (
            ess, psrf, float(d["sample_stats"]["lp"].mean())))
        assert np.isfinite(x).all()


if __name__ == "__main__":
    main()
