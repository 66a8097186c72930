"""Sequential model-based optimization with ``BaseModel.update``.

The use-case the reference positions itself for
(``/root/reference/docs/source/intro.rst:9-16``: hyperparameter
optimization needs calibrated uncertainties): fit a Bayesian neural
network to a handful of observations of an unknown objective, use the
posterior predictive to pick the next evaluation point (expected
improvement), observe it, and fold it in with
``model.update(X_new, y_new)`` — the incremental append-and-retrain API
of ``/root/reference/pysgmcmc/models/base_model.py:30-45``.

Runs in ~a minute on CPU; executed by ``make examples``.
"""

import numpy as np
from scipy.stats import norm

from pysgmcmc_tpu.models.bayesian_neural_network import (
    BayesianNeuralNetwork,
)


def objective(x):
    """A 1-D multimodal objective; global minimum near x = 0.757."""
    return np.sinc(3.0 * x - 1.0) + 0.3 * (x - 0.7) ** 2


def expected_improvement(mean, var, best):
    std = np.sqrt(np.maximum(var, 1e-12))
    z = (best - mean) / std
    return (best - mean) * norm.cdf(z) + std * norm.pdf(z)


def main():
    rng = np.random.RandomState(0)
    x_obs = rng.uniform(0.0, 1.0, (6, 1))
    y_obs = objective(x_obs[:, 0])

    model = BayesianNeuralNetwork(
        n_nets=8, n_iters=1200, burn_in_steps=300, sample_steps=100,
        batch_size=5, seed=1, log_every=None,
    )
    model.train(x_obs, y_obs)

    grid = np.linspace(0.0, 1.0, 201).reshape(-1, 1)
    for it in range(3):
        mean, var = model.predict(grid)
        _, best_y = model.get_incumbent()
        ei = expected_improvement(mean, var, best_y)
        x_next = grid[int(np.argmax(ei))]
        y_next = objective(x_next)
        print(
            "iter %d: incumbent y=%.4f -> evaluating x=%.3f (EI %.4f), "
            "observed y=%.4f"
            % (it, best_y, x_next[0], float(ei.max()), y_next[0])
        )
        # append-and-retrain: the reference's incremental update API
        model.update(x_next.reshape(1, 1), y_next)

    x_best, y_best = model.get_incumbent()
    print("final incumbent: x=%.3f y=%.4f (true optimum ~0.757)"
          % (x_best[0], y_best))
    assert np.isfinite(y_best)
    assert y_best <= y_obs.min() + 1e-9, "update() never improved on the seed"


if __name__ == "__main__":
    main()
