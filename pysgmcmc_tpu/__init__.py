"""pysgmcmc_tpu — a Stochastic Gradient MCMC framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``MFreidank/pysgmcmc`` (reference at ``/root/reference``): SG-MCMC samplers
(SGHMC, SGLD, Relativistic SGHMC, SVGD) as pure ``init/step`` functions,
whole sampling runs as single ``lax.scan`` programs, thousands of chains via
``vmap`` sharded over device meshes, and on-device diagnostics (ESS, Gelman-
Rubin) over device-resident chain histories.
"""

__version__ = "0.1.0"

from pysgmcmc_tpu import (
    data_batches,
    diagnostics,
    models,
    ops,
    parallel,
    samplers,
    stepsize_schedules,
    utils,
)
from pysgmcmc_tpu.sampling import Sampler

__all__ = [
    "Sampler",
    "samplers",
    "models",
    "diagnostics",
    "parallel",
    "ops",
    "utils",
    "data_batches",
    "stepsize_schedules",
]
