"""Render the result figure into docs/figures/banana_rsghmc.png.

The analog of the reference's executable-notebook output
(``/root/reference/docs/source/notebooks/Relativistic_SGHMC.ipynb`` — the
banana target reproduction), re-sampled live on the CPU (2-D target,
seconds).

Run: ``python docs/gen_figures.py`` (or ``make figures``).
"""

import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
OUT = os.path.join(HERE, "figures")

# slots 1-2 of the validated default categorical palette (light mode)
BLUE = "#2a78d6"
INK = "#333333"
MUTED = "#767676"
GRID = "#e3e3e3"

def _style(ax):
    ax.grid(True, color=GRID, linewidth=0.8, zorder=0)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(MUTED)
    ax.tick_params(colors=MUTED, labelsize=9)


def banana_figure():
    import jax
    import jax.numpy as jnp

    from pysgmcmc_tpu.diagnostics.objective_functions import (
        banana_log_likelihood,
        to_negative_log_likelihood,
    )  # noqa: F401
    from pysgmcmc_tpu.samplers.base import sample_chain
    from pysgmcmc_tpu.samplers.relativistic_sghmc import (
        RelativisticSGHMCSampler,
    )

    cost_fn = to_negative_log_likelihood(banana_log_likelihood)
    sampler = RelativisticSGHMCSampler(
        cost_fn, stepsize_schedule=0.1)
    state = sampler.init(jnp.zeros(2), jax.random.PRNGKey(0))
    _, draws, _ = sample_chain(
        sampler, state, jax.random.PRNGKey(1), 20000)
    draws = np.asarray(draws)[2000:]

    x = np.linspace(-30, 30, 200)
    y = np.linspace(-60, 20, 200)
    xx, yy = np.meshgrid(x, y)
    # the banana density on the grid (objective_functions.py formula)
    logp = -0.5 * (0.01 * xx**2 + (yy + 0.1 * xx**2 - 10.0) ** 2)

    fig, ax = plt.subplots(figsize=(5.2, 4.2))
    _style(ax)
    ax.contour(xx, yy, logp, levels=[-8, -4, -2, -1],
               colors=MUTED, linewidths=0.8, zorder=2)
    ax.plot(draws[:, 0], draws[:, 1], ".", color=BLUE, markersize=1.5,
            alpha=0.25, zorder=3, rasterized=True)
    ax.set_title("Relativistic SGHMC on the banana target\n"
                 "(reference notebook reproduction; 18k draws)",
                 fontsize=11, color=INK)
    ax.set_xlabel("x0", fontsize=9, color=MUTED)
    ax.set_ylabel("x1", fontsize=9, color=MUTED)
    fig.tight_layout()
    out = os.path.join(OUT, "banana_rsghmc.png")
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)


def main():
    os.makedirs(OUT, exist_ok=True)
    banana_figure()


if __name__ == "__main__":
    main()
