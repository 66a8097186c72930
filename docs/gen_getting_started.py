"""Generate the executed "Getting started" narrative page.

The reference ships executed Jupyter notebooks that interleave prose,
code and rendered output (``/root/reference/docs/source/notebooks/
api_quickstart.ipynb``, ``Relativistic_SGHMC.ipynb``).  Jupyter/Sphinx
are not available in this environment, so this generator IS the executed
notebook: a list of (markdown prose, code) cells is run top to bottom in
one shared namespace, stdout is captured per cell, matplotlib figures
are inlined as data URIs, and the result is one self-contained HTML page
(``docs/_build/html/getting_started.html``).

Usage: ``python docs/gen_getting_started.py [output_dir]`` — wired to
``make docs`` and run by CI full mode, so the page can never go stale
relative to the API it demonstrates.
"""

import base64
import contextlib
import html
import io
import os
import re
import sys
import textwrap

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


STYLE = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       max-width: 54rem; margin: 2rem auto; padding: 0 1rem;
       color: #1a1a2e; line-height: 1.55; }
h1, h2, h3 { color: #16324f; }
code { font-family: 'SF Mono', Consolas, monospace; font-size: 0.9em;
       background: #f2f4f7; padding: 0.1em 0.3em; border-radius: 3px; }
pre { background: #f6f8fa; border: 1px solid #d8dee4; border-radius: 6px;
      padding: 0.8rem; overflow-x: auto; }
pre code { background: none; padding: 0; }
pre.output { background: #0d1117; color: #e6edf3;
             border-color: #30363d; }
img { max-width: 100%; border: 1px solid #d8dee4; border-radius: 6px;
      margin: 0.5rem 0; }
table { border-collapse: collapse; margin: 0.8rem 0; }
td, th { border: 1px solid #d8dee4; padding: 0.3rem 0.7rem; }
.cellno { color: #888; font-size: 0.8em; }
"""


def md_lite(text):
    """Markdown-lite -> HTML: headers, inline code, bold, links, lists,
    tables, paragraphs.  Enough for narrative prose; not a general
    markdown engine."""
    out = []
    lines = textwrap.dedent(text).strip().split("\n")
    para, in_list, in_table = [], False, False

    def inline(s):
        s = html.escape(s)
        s = re.sub(r"`([^`]+)`", r"<code>\1</code>", s)
        s = re.sub(r"\*\*([^*]+)\*\*", r"<strong>\1</strong>", s)
        s = re.sub(r"\[([^\]]+)\]\(([^)]+)\)", r'<a href="\2">\1</a>', s)
        return s

    def flush():
        if para:
            out.append("<p>{}</p>".format(inline(" ".join(para))))
            para.clear()

    for line in lines + [""]:
        stripped = line.strip()
        if stripped.startswith("|"):
            flush()
            cells = [c.strip() for c in stripped.strip("|").split("|")]
            if set("".join(cells)) <= set("-: "):
                continue
            if not in_table:
                out.append("<table>")
                in_table = True
            out.append(
                "<tr>" + "".join(
                    "<td>{}</td>".format(inline(c)) for c in cells)
                + "</tr>")
            continue
        if in_table:
            out.append("</table>")
            in_table = False
        if stripped.startswith("#"):
            flush()
            level = len(stripped) - len(stripped.lstrip("#"))
            out.append("<h{0}>{1}</h{0}>".format(
                min(level, 4), inline(stripped.lstrip("# "))))
        elif stripped.startswith("- "):
            flush()
            if not in_list:
                out.append("<ul>")
                in_list = True
            out.append("<li>{}</li>".format(inline(stripped[2:])))
        elif not stripped:
            flush()
            if in_list:
                out.append("</ul>")
                in_list = False
        else:
            para.append(stripped)
    return "\n".join(out)


def run_cells(cells):
    """Execute code cells in one shared namespace; capture stdout and any
    matplotlib figures produced.  Returns HTML blocks."""
    ns = {}
    blocks = []
    n = 0
    for prose, code in cells:
        if prose:
            blocks.append(md_lite(prose))
        if not code:
            continue
        n += 1
        code = textwrap.dedent(code).strip()
        blocks.append(
            '<div class="cellno">In [{}]:</div>'
            "<pre><code>{}</code></pre>".format(n, html.escape(code)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            exec(compile(code, "<cell {}>".format(n), "exec"), ns)
        text = buf.getvalue().rstrip()
        if text:
            blocks.append(
                '<pre class="output">{}</pre>'.format(html.escape(text)))
        for num in plt.get_fignums():
            img = io.BytesIO()
            plt.figure(num).savefig(
                img, format="png", dpi=110, bbox_inches="tight")
            blocks.append(
                '<img alt="figure" src="data:image/png;base64,{}"/>'.format(
                    base64.b64encode(img.getvalue()).decode()))
        plt.close("all")
    return blocks


CELLS = [
    ("""
# Getting started with pysgmcmc_tpu

`pysgmcmc_tpu` is a JAX framework for **Stochastic Gradient Markov
Chain Monte Carlo** — Bayesian posterior sampling when only noisy
minibatch gradients of the target are available.  It covers the full
capability surface of the reference library
[MFreidank/pysgmcmc](https://github.com/MFreidank/pysgmcmc), redesigned
for JAX/XLA: whole chains compile into one `lax.scan`, and thousands of
chains vmap and shard over device meshes.  It runs on a GPU.

This page is the executed-notebook analog of the reference's
`api_quickstart.ipynb`: every code cell below RAN during `make docs`,
and its printed output and plots are what you see.  (This build runs on
the CPU; speed is measured on the GPU, see `PERF.md`.)

## 1. Samplers through the factory, and the iterator protocol

Samplers are built directly or through the reference-compatible
`Sampler` enum factory.  The reference's iterator protocol
(`sample, cost = next(sampler)`) is preserved:
""",
     """
import jax, jax.numpy as jnp, numpy as np

from pysgmcmc_tpu import Sampler
from pysgmcmc_tpu.samplers import IterativeSampler, sample_chain
from pysgmcmc_tpu.diagnostics.objective_functions import (
    gmm1_log_likelihood, to_negative_log_likelihood)

cost_fn = to_negative_log_likelihood(gmm1_log_likelihood)
sampler = Sampler.get_sampler(
    Sampler.SGHMC, cost_fn=cost_fn, stepsize_schedule=0.05,
    burn_in_steps=300)

it = IterativeSampler(sampler, params=jnp.zeros(1), key=0)
for _ in range(3):
    sample, cost = next(it)
    print("next(sampler) -> sample %s  cost %.3f"
          % (np.asarray(sample), float(cost)))
"""),
    ("""
## 2. Whole chains as one compiled program

The idiomatic fast path replaces the per-step iterator with a single
jitted `lax.scan`: burn-in adaptation, stepsize schedule, thinning and
sample collection all trace into one device program — zero host round
trips per step (the reference pays one `session.run` per draw).  50,000
steps on the three-mode `gmm1` mixture:
""",
     """
state = sampler.init(jnp.zeros(1))
state, samples, costs = sample_chain(
    sampler, state, jax.random.PRNGKey(0), n_samples=50_000)
draws = np.asarray(samples)[10_000:, 0]
print("mean %.2f  std %.2f" % (draws.mean(), draws.std()))

import matplotlib.pyplot as plt
from pysgmcmc_tpu.diagnostics.objective_functions import gmm1_log_likelihood as g1

grid = np.linspace(-9, 9, 400)
dens = np.exp([float(g1(jnp.asarray([t]))) for t in grid])
fig, ax = plt.subplots(figsize=(7, 3))
ax.hist(draws, bins=120, density=True, alpha=0.6, label="SGHMC draws")
ax.plot(grid, dens, "k", lw=1.2, label="target density")
ax.set_xlabel("x"); ax.legend(); ax.set_title("gmm1: all three modes")
"""),
    ("""
## 3. Stepsize schedules

The reference ships constant schedules only; here polynomial decay,
cyclical (cSG-MCMC) and traced-sweep schedules compose with every
sampler — and run *exactly* through the fused multi-step kernels (the
drivers ship a per-step stepsize row into the kernel).
""",
     """
from pysgmcmc_tpu.stepsize_schedules import CyclicalStepsizeSchedule

cyclical = Sampler.get_sampler(
    Sampler.SGHMC, cost_fn=cost_fn,
    stepsize_schedule=CyclicalStepsizeSchedule(0.1, cycle_length=2000),
    burn_in_steps=300)
state = cyclical.init(jnp.zeros(1))
_, samples, _ = sample_chain(cyclical, state, jax.random.PRNGKey(1), 10_000)
print("cyclical-schedule chain spans modes: min %.1f max %.1f"
      % (float(samples.min()), float(samples.max())))
"""),
    ("""
## 4. Parallel chains and diagnostics

Chains are the parallelism axis: `pysgmcmc_multitrace` runs all chains
as ONE vmapped (optionally mesh-sharded) program, where the reference
looped fresh TF sessions.  The on-device diagnostics (FFT-autocovariance
ESS, Gelman-Rubin PSRF) consume the stacked histories directly:
""",
     """
from pysgmcmc_tpu.diagnostics import (
    effective_sample_size, gelman_rubin, pysgmcmc_multitrace)

multitrace = pysgmcmc_multitrace(
    sampler, jnp.zeros(1), key=2, n_chains=4, samples_per_chain=2000,
    keep_every=5, jitter=3.0, varnames=["x"])
chains = multitrace.chains_array("x")
print("4 chains x 2000 draws: ESS %.0f  R-hat %.3f" % (
    float(np.asarray(effective_sample_size(chains)).ravel()[0]),
    float(np.asarray(gelman_rubin(chains)).ravel()[0])))
"""),
    ("""
## 5. Ecosystem interop: ArviZ export

Posteriors export to the `arviz.InferenceData` ecosystem (the modern
analog of the reference's pymc3 `MultiTrace` interop).  Without arviz
installed, `to_inference_dict` gives the same `(chain, draw, *shape)`
layout dependency-free:
""",
     """
from pysgmcmc_tpu.diagnostics import to_inference_dict

d = to_inference_dict(multitrace)
print({group: {name: arr.shape for name, arr in vars_.items()}
       for group, vars_ in d.items()})
"""),
    ("""
## 6. Bayesian neural networks

`models.BayesianNeuralNetwork` reproduces the reference's
heteroscedastic regression BNN (3x50-tanh, learned log-variance output,
Gaussian priors) trained by sampling.  Training is one compiled scan;
prediction is one vmapped ensemble pass.  The hidden layers are set
with `units=`, and `step_impl="lanes"` runs both phases on the packed
chains-on-lanes drivers:
""",
     """
from pysgmcmc_tpu.models import BayesianNeuralNetwork
from pysgmcmc_tpu.diagnostics.objective_functions import sinc

rng = np.random.RandomState(1)
x_train = rng.uniform(0, 1, (100, 1))
y_train = np.asarray(sinc(x_train))
x_test = np.linspace(0, 1, 200)[:, None]

bnn = BayesianNeuralNetwork(
    network="dense", n_chains=2, n_nets=16, burn_in_steps=1000,
    seed=1, log_every=None)
bnn.train(x_train, y_train)
mean, var = bnn.predict(x_test)
print("sinc predictive MSE: %.5f"
      % float(np.mean((mean - np.asarray(sinc(x_test)).ravel()) ** 2)))

fig, ax = plt.subplots(figsize=(7, 3))
sd = np.sqrt(var)
ax.plot(x_test, np.asarray(sinc(x_test)), "k--", lw=1, label="sinc")
ax.plot(x_test, mean, lw=1.5, label="posterior mean")
ax.fill_between(x_test[:, 0], mean - 2 * sd, mean + 2 * sd, alpha=0.25,
                label="+/- 2 sd")
ax.scatter(x_train, y_train, s=8, c="k", alpha=0.5, label="train data")
ax.legend(ncol=4, fontsize=8); ax.set_title("BNN posterior predictive")
"""),
    ("""
## 7. Where the speed comes from

- **One compiled program per phase**: thousands of chains advance in
  lockstep inside one jitted `vmap(scan)`; the sampling phase drops the
  frozen adaptation statistics from the loop carry.
- **Chains-on-lanes** (`parallel.packed`): the sampler state packed as
  one dense matrix per array, for arbitrary cost functions and all five
  samplers, burn-in included.
- **Mesh scaling** (`parallel/`): chains shard over 1-D device meshes and
  2-D (hosts, devices) meshes; the hot loop is collective-free.
- **Streaming SVGD** (`ops.svgd_streaming`): the kernel reductions
  accumulate over column tiles, so the n x n kernel matrix is never
  materialized.

Measurements on the GPU are in `PERF.md`.  The result figure (rendered
by `make figures` from a live CPU chain):

![RSGHMC banana](figures/banana_rsghmc.png)

Next steps: the [API reference](index.html), the executable
`examples/`, and `PARITY.md` for the line-by-line reference-component
map.
""",
     None),
]


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "docs/_build/html"
    os.makedirs(out_dir, exist_ok=True)
    # ship the committed result figures next to the page
    import shutil

    fig_src = os.path.join(os.path.dirname(__file__), "figures")
    fig_dst = os.path.join(out_dir, "figures")
    if os.path.isdir(fig_src):
        os.makedirs(fig_dst, exist_ok=True)
        for name in os.listdir(fig_src):
            if name.endswith(".png"):
                shutil.copy2(os.path.join(fig_src, name), fig_dst)
    blocks = run_cells(CELLS)
    page = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        "<title>Getting started — pysgmcmc_tpu</title>"
        "<style>{}</style></head><body>{}</body></html>".format(
            STYLE, "\n".join(blocks)))
    path = os.path.join(out_dir, "getting_started.html")
    with open(path, "w") as f:
        f.write(page)
    print("wrote {} ({} cells executed)".format(
        path, sum(1 for _, c in CELLS if c)))


if __name__ == "__main__":
    main()
