"""Smoke check of the sampler stack on a GPU, through its user entry points.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the mesh paths on four cards, each
                                       # compared with the same run on one

It exits non-zero, and prints no result line, when JAX finds no GPU or any
check fails.  The last line of a passing run is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Phases of the one-card run:

0. device, card name and power limit, JAX version, compile-cache directory;
1. the flagship (``bench.py``: 8192 SGHMC chains of the 3x50 BNN on sinc)
   burn-in and sampling programs lowered and compiled, with
   ``memory_analysis()``;
2. the flagship run, and 16 of its chains re-run from the same states and
   keys on the CPU (float32 reference) and on the card at precision
   "highest" and at default precision;
3. ``BayesianNeuralNetwork.train``/``predict`` at the reference's quality
   gate (sinc MSE < 0.1), multi-chain, ``step_impl='lanes'``, and the bf16
   serving path;
4. SGLD, pSGLD, SGNHT and relativistic SGHMC at the flagship shape, with
   the same CPU comparison;
5. SVGD's dense and streaming transport against a float64 reference, and
   ESS / Gelman-Rubin over a flagship history;
6. the card-only tests (``tests/test_on_card.py``, marker ``gpu``), run
   inside this process: the minibatch selector against plain indexing,
   bitwise, and streaming against dense SVGD.
"""

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_REF = 16          # chains re-run for the CPU comparison
SEED = 0

# Tolerances of the card-vs-CPU comparisons: largest absolute deviation of
# any position, and largest relative deviation of any final cost.
#
# Precision "highest" runs float32 matmuls in full float32, so the card
# and the CPU differ only in operation order and in their transcendental
# functions: a few ulp per operation per step.  How far such differences
# grow was measured on the CPU by starting one run 1 ulp off the other:
# burn-in 50 steps 1.3e-6, sampling 200 steps 1.2e-5, SGLD / SGNHT /
# RSGHMC 300 steps <= 2.2e-6, pSGLD 300 steps 8.3e-4 (its preconditioner
# 1/(1e-5 + sqrt(v)) amplifies coordinates with tiny v); costs <= 6.4e-6
# relative.  The tolerances are 1000x those growths, rounded up.
HIGHEST_TOL = {
    "burn_in_50": (1e-3, 1e-3),
    "sampling_200": (1e-2, 1e-3),
    "SGLD": (1e-2, 1e-3),
    "pSGLD": (1.0, 1e-3),
    "SGNHT": (1e-2, 1e-3),
    "RSGHMC": (1e-2, 1e-3),
}
# At default precision the card may round float32 matmul inputs to TF32
# (10 mantissa bits).  A CPU emulation of that rounding moved burn-in-50
# positions by 0.35 and sampling-200 positions by 1.16 (costs 72%): the
# trajectories are then different draws of the same chain, so the bound
# only catches results no rounding explains (10x the emulated deviation).
DEFAULT_TOL = {
    "burn_in_50": (3.5, 1.0),
    "sampling_200": (12.0, 7.2),
}
# predict(compute_dtype=bfloat16) vs float32: bf16 keeps 8 mantissa bits
# (2^-9 relative rounding); on the CPU the sinc ensemble's predictive mean
# moved by 3.8e-3.  Bound: 0.02, below the ensemble's own predictive std.
BF16_PREDICT_TOL = 0.02
# SVGD transport vs a float64 reference, relative to max |phi|: float32
# Gram-form distances |x|^2 + |y|^2 - 2 x.y cancel in the leading bits
# when particles are close, so allow 1e-3 at precision "highest".
SVGD_TOL = 1e-3
# Sharded (four cards) vs one card: the per-device program is the same,
# but XLA may pick other kernels for another batch size, so the same
# rounding-growth argument as HIGHEST_TOL applies.
MESH_TOL = 1e-2


def check(ok, message):
    if not ok:
        raise RuntimeError("check failed: " + message)


def max_abs(a, b):
    import jax

    return max(
        float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y))))
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b))
    )


def max_rel(a, b):
    if a is None:
        return 0.0
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def all_finite(tree):
    import jax

    return all(np.isfinite(np.asarray(leaf)).all()
               for leaf in jax.tree_util.tree_leaves(tree))


@contextlib.contextmanager
def phase(name):
    print("== phase {} ...".format(name), flush=True)
    start = time.perf_counter()
    yield
    print("== phase {} ok ({:.1f} s)".format(
        name, time.perf_counter() - start), flush=True)


def take(tree, n):
    import jax

    return jax.tree_util.tree_map(lambda leaf: np.asarray(leaf[:n]), tree)


def on_cpu(tree):
    import jax

    cpu = jax.devices("cpu")[0]
    return jax.tree_util.tree_map(lambda leaf: jax.device_put(leaf, cpu), tree)


def compare_runs(name, make_fn, args, tols, default_tols=None):
    """Run ``make_fn()(*args) -> (positions, costs or None)`` (a fresh
    jitted function each time) on the CPU, on the card at precision
    "highest" and at default precision, and check each card run against
    the CPU run."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = make_fn()(*on_cpu(args))
    ref_pos, ref_cost = ref
    results = {}
    for label, precision in (("highest", "highest"), ("default", None)):
        ctx = (jax.default_matmul_precision(precision) if precision
               else contextlib.nullcontext())
        with ctx:
            pos, cost = make_fn()(*args)
        check(all_finite((pos, cost)), name + " " + label + ": non-finite")
        results[label] = (max_abs(pos, ref_pos), max_rel(cost, ref_cost))
    print("  {:14s} vs CPU: highest pos {:.3e} cost {:.3e} | default pos "
          "{:.3e} cost {:.3e}".format(
              name, *results["highest"], *results["default"]))
    pos_tol, cost_tol = tols
    check(results["highest"][0] <= pos_tol and results["highest"][1] <= cost_tol,
          "{} at precision highest deviates beyond ({}, {})".format(
              name, pos_tol, cost_tol))
    if default_tols is not None:
        check(results["default"][0] <= default_tols[0]
              and results["default"][1] <= default_tols[1],
              "{} at default precision deviates beyond {}".format(
                  name, default_tols))
    return results


#  Phases ---------------------------------------------------------------------


def flagship_compile(n_chains):
    import jax

    import bench

    sampler, positions, select_batch = bench.build_workload(n_chains)
    init_and_burn, sampling = bench.chain_programs(sampler, select_batch)
    keys_burn = jax.random.split(jax.random.PRNGKey(SEED + 2), n_chains)
    compiled = {}
    burn_lowered = jax.jit(jax.vmap(init_and_burn)).lower(positions, keys_burn)
    start = time.perf_counter()
    compiled["burn"] = burn_lowered.compile()
    print("  burn-in ({} steps) compiled in {:.1f} s; memory: {}".format(
        bench.BURN_IN_STEPS, time.perf_counter() - start,
        compiled["burn"].memory_analysis()))
    states_shape = jax.eval_shape(jax.vmap(init_and_burn), positions, keys_burn)
    sample_lowered = jax.jit(jax.vmap(sampling)).lower(states_shape, keys_burn)
    start = time.perf_counter()
    compiled["sample"] = sample_lowered.compile()
    print("  sampling ({} steps) compiled in {:.1f} s; memory: {}".format(
        bench.SCAN_STEPS, time.perf_counter() - start,
        compiled["sample"].memory_analysis()))
    return sampler, positions, select_batch, compiled


def flagship_run(n_chains, sampler, positions, select_batch, compiled):
    import jax

    import bench

    keys_burn = jax.random.split(jax.random.PRNGKey(SEED + 2), n_chains)
    states = compiled["burn"](positions, keys_burn)
    jax.block_until_ready(states)
    check(all_finite(states), "flagship burn-in: non-finite state")
    keys_sample = jax.random.split(jax.random.PRNGKey(SEED + 3), n_chains)
    sampled, costs = compiled["sample"](states, keys_sample)
    jax.block_until_ready(sampled)
    check(all_finite((sampled, costs)), "flagship sampling: non-finite")
    times = []
    timed = sampled
    for i in range(3):
        keys = jax.random.split(jax.random.PRNGKey(SEED + 10 + i), n_chains)
        start = time.perf_counter()
        timed, _ = compiled["sample"](timed, keys)
        jax.block_until_ready(timed)
        times.append(time.perf_counter() - start)
    step_s = float(np.median(times)) / bench.SCAN_STEPS
    print("  flagship sampling step: {:.4f} ms/step, {:.0f} steps/sec "
          "({} chains, median of 3 segments)".format(
              1e3 * step_s, n_chains / step_s, n_chains))

    # the same per-chain programs on N_REF chains, from the same states
    # and keys, on the CPU and on the card

    def burn50():
        s, _, sel = bench.build_workload(N_REF)
        burn, _ = bench.chain_programs(s, sel, burn_in_steps=50)
        return jax.jit(jax.vmap(lambda p, k: (burn(p, k).position, None)))

    def sample200():
        s, _, sel = bench.build_workload(N_REF)
        _, sampling = bench.chain_programs(s, sel)

        def run(state, key):
            state, cost = sampling(state, key)
            return state.position, cost
        return jax.jit(jax.vmap(run))

    compare_runs("burn_in_50", burn50,
                 (take(positions, N_REF), take(keys_burn, N_REF)),
                 HIGHEST_TOL["burn_in_50"], DEFAULT_TOL["burn_in_50"])
    tf32 = compare_runs("sampling_200", sample200,
                        (take(states, N_REF), take(keys_sample, N_REF)),
                        HIGHEST_TOL["sampling_200"],
                        DEFAULT_TOL["sampling_200"])
    in_play = tf32["default"][0] > HIGHEST_TOL["sampling_200"][0]
    print("  TF32 in play at default precision on this path: {}".format(
        "yes" if in_play else "no"))
    return states


def model_phase():
    import jax.numpy as jnp

    from pysgmcmc_tpu.diagnostics.objective_functions import sinc
    from pysgmcmc_tpu.models import BayesianNeuralNetwork

    rng = np.random.RandomState(1)
    x = rng.uniform(0.0, 1.0, (100, 1))
    y = np.asarray(sinc(x))
    x_test = np.linspace(0.0, 1.0, 200)[:, None]
    y_test = np.asarray(sinc(x_test))
    mse = {}
    for label, kwargs in (
        ("single chain", {}),
        ("n_chains=8", dict(n_chains=8, n_nets=16)),
        ("lanes, n_chains=8", dict(n_chains=8, n_nets=16, step_impl="lanes")),
    ):
        bnn = BayesianNeuralNetwork(
            **dict(dict(burn_in_steps=1000, n_nets=10, seed=1), **kwargs))
        start = time.perf_counter()
        bnn.train(x, y)
        mean, var = bnn.predict(x_test)
        mse[label] = float(np.mean((mean - y_test) ** 2))
        print("  {:18s} train+predict {:.1f} s, sinc MSE {:.5f}".format(
            label, time.perf_counter() - start, mse[label]))
        check(np.isfinite(mean).all() and (var >= 0).all(),
              label + ": bad predictions")
        check(mse[label] < 0.1, label + ": sinc MSE not below 0.1")
        if label == "single chain":
            mean_bf16, _ = bnn.predict(x_test, compute_dtype=jnp.bfloat16)
            dev = float(np.max(np.abs(mean_bf16 - mean)))
            print("  bf16 predict vs f32: max |mean| deviation {:.3e} "
                  "(tolerance {})".format(dev, BF16_PREDICT_TOL))
            check(dev <= BF16_PREDICT_TOL, "bf16 predict deviates")


def family_samplers(base):
    from pysgmcmc_tpu.samplers import (
        PSGLDSampler,
        RelativisticSGHMCSampler,
        SGLDSampler,
        SGNHTSampler,
    )

    common = dict(gaussian_prior_scale=base.gaussian_prior_scale)
    return {
        "SGLD": SGLDSampler(
            base.cost_fn, stepsize_schedule=1e-5, burn_in_steps=100,
            scale_grad=base.scale_grad, **common),
        "pSGLD": PSGLDSampler(
            base.cost_fn, stepsize_schedule=1e-4,
            scale_grad=base.scale_grad, **common),
        "SGNHT": SGNHTSampler(
            base.cost_fn, stepsize_schedule=1e-3,
            scale_grad=base.scale_grad, **common),
        "RSGHMC": RelativisticSGHMCSampler(
            base.cost_fn, stepsize_schedule=1e-3, **common),
    }


def family_program(sampler, select_batch, n_steps):
    import jax

    from pysgmcmc_tpu.samplers.base import sample_chain

    def one_chain(position, chain_key):
        k_init, k_run = jax.random.split(chain_key)
        state = sampler.init(position, k_init)
        state, _, costs = sample_chain(
            sampler, state, k_run, 1, batch_fn=select_batch,
            keep_every=n_steps)
        return state.position, costs[-1]

    return jax.jit(jax.vmap(one_chain))


def family_phase(n_chains, n_steps=300):
    import jax

    import bench

    base, positions, select_batch = bench.build_workload(n_chains)
    keys = jax.random.split(jax.random.PRNGKey(SEED + 4), n_chains)
    for name, sampler in family_samplers(base).items():
        start = time.perf_counter()
        pos, costs = family_program(sampler, select_batch, n_steps)(
            positions, keys)
        jax.block_until_ready(costs)
        check(all_finite((pos, costs)), name + ": non-finite")
        print("  {:6s} {} chains x {} steps in {:.1f} s (compile "
              "included)".format(name, n_chains, n_steps,
                                 time.perf_counter() - start))

        def make(name=name):
            b, _, sel = bench.build_workload(N_REF)
            return family_program(family_samplers(b)[name], sel, n_steps)

        compare_runs(name, make, (take(positions, N_REF), take(keys, N_REF)),
                     HIGHEST_TOL[name])


def svgd_reference_phi(x, g):
    """Plain float64 SVGD transport (numpy), median-heuristic bandwidth."""
    x = np.asarray(x, np.float64)
    g = np.asarray(g, np.float64)
    n = x.shape[0]
    sq = np.sum(x * x, axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
    h = np.sqrt(0.5 * np.median(d2) / np.log(n + 1.0))
    k = np.exp(-d2 / (2.0 * h * h))
    phi = (k @ (-g) + (x * k.sum(axis=1)[:, None] - k @ x) / h**2) / n
    return phi, h


def svgd_phase(states, sampler, select_batch):
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from pysgmcmc_tpu.ops.pairwise import svgd_kernel
    from pysgmcmc_tpu.ops.svgd_streaming import svgd_phi_streaming

    flat = jax.vmap(lambda p: ravel_pytree(p)[0])(states.position)
    template = jax.tree_util.tree_map(lambda leaf: leaf[0], states.position)
    unravel = ravel_pytree(template)[1]
    batch = select_batch(jax.random.PRNGKey(SEED + 5))
    grads = jax.jit(jax.vmap(lambda row: ravel_pytree(jax.grad(
        sampler.cost_fn)(unravel(row), batch))[0]))(flat)
    n, d = flat.shape
    ref, h = svgd_reference_phi(flat, grads)
    scale = float(np.max(np.abs(ref)))
    with jax.default_matmul_precision("highest"):
        @jax.jit
        def dense(x, g):
            kernel, grad_kernel = svgd_kernel(x)
            return (jnp.dot(kernel, -g) + grad_kernel) / x.shape[0]

        phi_dense = dense(flat, grads)
        phi_stream = svgd_phi_streaming(flat, grads, jnp.float32(h), tile=512)
    for label, phi in (("dense", phi_dense), ("streaming", phi_stream)):
        err = float(np.max(np.abs(np.asarray(phi, np.float64) - ref))) / scale
        print("  SVGD {} phi vs float64 reference (n={}, d={}, precision "
              "highest): max deviation / max |phi| = {:.3e}".format(
                  label, n, d, err))
        check(err <= SVGD_TOL, "SVGD {} phi deviates".format(label))


def diagnostics_phase(sampler, positions, select_batch, n_chains):
    import jax
    import jax.numpy as jnp

    from pysgmcmc_tpu.diagnostics.sampler_diagnostics import (
        effective_sample_size,
        gelman_rubin,
    )
    from pysgmcmc_tpu.models.architectures import default_network
    from pysgmcmc_tpu.parallel.chains import run_chains

    history, costs = run_chains(
        sampler, positions, jax.random.PRNGKey(SEED + 6), 20,
        batch_fn=select_batch, keep_every=10)
    _, apply_fn = default_network(1)
    probes = jnp.linspace(0.0, 1.0, 8).reshape(8, 1)
    f_vals = jax.jit(jax.vmap(jax.vmap(
        lambda p: apply_fn(p, probes)[:, 0])))(history)
    ess = np.asarray(jax.jit(effective_sample_size)(f_vals))
    psrf = np.asarray(jax.jit(gelman_rubin)(f_vals))
    print("  ESS over {} chains x 20 draws at 8 probe inputs: {}".format(
        n_chains, np.array2string(ess, precision=1)))
    print("  Gelman-Rubin: {}".format(np.array2string(psrf, precision=3)))
    check(np.isfinite(ess).all() and np.isfinite(psrf).all(),
          "non-finite diagnostics")
    check(np.isfinite(np.asarray(costs)).all(), "non-finite history costs")


def card_tests_phase():
    import pytest

    class Outcomes:
        def __init__(self):
            self.passed, self.other = [], []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed.append(report.nodeid)
            elif report.failed or report.skipped:
                self.other.append((report.nodeid, report.outcome))

    outcomes = Outcomes()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", "-o", "addopts=",
         os.path.join(REPO, "tests", "test_on_card.py")],
        plugins=[outcomes])
    print("  card-only tests passed: {}".format(len(outcomes.passed)))
    check(rc == 0 and outcomes.passed and not outcomes.other,
          "card-only tests: exit {}, not passed: {}".format(
              rc, outcomes.other))


def four_cards(devices):
    """The paths users run across devices, each vs the same run on one."""
    import jax
    import jax.numpy as jnp

    import bench
    from pysgmcmc_tpu.diagnostics.objective_functions import sinc
    from pysgmcmc_tpu.diagnostics.sampler_diagnostics import (
        effective_sample_size,
        gelman_rubin,
    )
    from pysgmcmc_tpu.models import BayesianNeuralNetwork
    from pysgmcmc_tpu.parallel.chains import run_chains
    from pysgmcmc_tpu.parallel.mesh import chain_mesh
    from pysgmcmc_tpu.parallel.svgd import run_svgd_sharded
    from pysgmcmc_tpu.samplers.svgd import SVGDSampler

    check(len(devices) == 4, "--four-cards needs 4 GPUs, found {}".format(
        len(devices)))
    mesh = chain_mesh(4)

    with phase("4a run_chains on 4 x 2048 chains"):
        n_chains = 4 * 2048
        sampler, positions, select_batch = bench.build_workload(n_chains)
        with jax.default_matmul_precision("highest"):
            sharded = run_chains(sampler, positions, jax.random.PRNGKey(1), 2,
                                 batch_fn=select_batch, keep_every=25,
                                 mesh=mesh)
            single = run_chains(sampler, positions, jax.random.PRNGKey(1), 2,
                                batch_fn=select_batch, keep_every=25)
        jax.block_until_ready((sharded, single))
        shards = {s.device for s in sharded[1].addressable_shards}
        check(len(shards) == 4, "outputs not sharded over 4 cards")
        pos_dev = max_abs(sharded[0], single[0])
        cost_dev = max_rel(sharded[1], single[1])
        print("  sharded vs one card: positions {:.3e}, costs {:.3e} "
              "(tolerance {})".format(pos_dev, cost_dev, MESH_TOL))
        check(pos_dev <= MESH_TOL and cost_dev <= MESH_TOL,
              "sharded run_chains deviates")

    with phase("4b pooled ESS / Gelman-Rubin over the sharded history"):
        history = sharded[0]
        probes = jnp.linspace(0.0, 1.0, 8).reshape(8, 1)
        from pysgmcmc_tpu.models.architectures import default_network

        _, apply_fn = default_network(1)
        f_vals = jax.jit(jax.vmap(jax.vmap(
            lambda p: apply_fn(p, probes)[:, 0])))(history)
        f_single = jax.device_put(np.asarray(f_vals), devices[0])
        for name, fn in (("ESS", effective_sample_size),
                         ("Gelman-Rubin", gelman_rubin)):
            got = np.asarray(jax.jit(fn)(f_vals))
            want = np.asarray(jax.jit(fn)(f_single))
            dev = max_rel(got, want)
            print("  {} sharded vs one card: {:.3e} relative".format(
                name, dev))
            check(np.isfinite(got).all() and dev <= 1e-4,
                  name + " over the sharded history deviates")

    with phase("4c BayesianNeuralNetwork(n_chains=8, n_nets=16, mesh)"):
        rng = np.random.RandomState(1)
        x = rng.uniform(0.0, 1.0, (100, 1))
        y = np.asarray(sinc(x))
        x_test = np.linspace(0.0, 1.0, 200)[:, None]
        y_test = np.asarray(sinc(x_test))
        means = {}
        for label, mesh_arg in (("4 cards", mesh), ("1 card", None)):
            bnn = BayesianNeuralNetwork(
                burn_in_steps=1000, n_nets=16, n_chains=8, seed=1,
                mesh=mesh_arg)
            bnn.train(x, y)
            means[label], _ = bnn.predict(x_test)
            mse = float(np.mean((means[label] - y_test) ** 2))
            print("  {}: sinc MSE {:.5f}".format(label, mse))
            check(mse < 0.1, label + ": sinc MSE not below 0.1")
        dev = float(np.max(np.abs(means["4 cards"] - means["1 card"])))
        print("  predictive mean, 4 cards vs 1: max deviation {:.3e} "
              "(tolerance {})".format(dev, 2 * BF16_PREDICT_TOL))
        # 2000 chaotic steps: compared like draws, at the bf16 bound
        check(dev <= 2 * BF16_PREDICT_TOL, "sharded BNN deviates")

    with phase("4d run_svgd_sharded (all_gather over 4 cards)"):
        svgd = SVGDSampler(lambda p: 0.5 * jnp.sum(p ** 2),
                           stepsize_schedule=0.05)
        particles = jax.random.normal(jax.random.PRNGKey(3), (4096, 64))
        with jax.default_matmul_precision("highest"):
            got, _ = run_svgd_sharded(svgd, svgd.init(particles),
                                      jax.random.PRNGKey(4), 10, mesh)
            want, _ = run_svgd_sharded(svgd, svgd.init(particles),
                                       jax.random.PRNGKey(4), 10,
                                       chain_mesh(1))
        dev = max_abs(got.position, want.position)
        print("  sharded vs one card after 10 steps: {:.3e} (tolerance "
              "{})".format(dev, SVGD_TOL))
        check(dev <= SVGD_TOL, "sharded SVGD deviates")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the mesh paths on four cards, each compared with "
             "the same run on one card")
    args = parser.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    import bench
    from pysgmcmc_tpu.utils.device import (
        device_record,
        enable_compile_cache,
        nvidia_smi_name_and_power_limit,
        require_gpu,
    )

    with phase("0 device"):
        devices = require_gpu()
        cache = enable_compile_cache(os.path.join(REPO, ".jax_cache"))
        print("  device_kind {!r}, {} device(s)".format(
            devices[0].device_kind, len(devices)))
        print("  nvidia-smi: {}".format(nvidia_smi_name_and_power_limit()))
        print("  jax {}, compile cache {}".format(jax.__version__, cache))

    if args.four_cards:
        four_cards(devices)
    else:
        n_chains = bench.N_CHAINS
        with phase("1 flagship compile"):
            sampler, positions, select_batch, compiled = flagship_compile(
                n_chains)
        with phase("2 flagship run and CPU comparison"):
            states = flagship_run(
                n_chains, sampler, positions, select_batch, compiled)
        with phase("3 BayesianNeuralNetwork train/predict"):
            model_phase()
        with phase("4 sampler family"):
            family_phase(n_chains)
        with phase("5 SVGD and diagnostics"):
            svgd_phase(states, sampler, select_batch)
            diagnostics_phase(sampler, positions, select_batch, n_chains)
        with phase("6 card-only tests"):
            card_tests_phase()

    print(json.dumps({"ok": True, "device": device_record(devices)}))


if __name__ == "__main__":
    main()
