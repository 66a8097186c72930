"""Mutation-testing analog: verify the test suite has teeth.

The reference aspires to mutation testing via a cosmic-ray Makefile target
that was never wired up (``/root/reference/pysgmcmc/Makefile:26-28``).  This
is the working equivalent, sized for CI: a curated set of single-line
mutants of the framework's load-bearing numerics, each of which MUST be
killed (detected as a failure) by a targeted, fast test selection.

For every mutant the harness copies the package + tests into a temp tree,
applies the mutation (asserting it matched exactly once), and runs the
listed tests there.  A mutant that survives (tests stay green) is a hole in
the suite and fails this script.  A final no-op pass asserts the same test
selections are green on the unmutated tree, so kills are attributable to
the mutation and not to environment breakage.

Run: ``python ci/mutation_check.py`` (CPU; ~2-4 min).  Wired to
``make mutation`` — the analog of the reference's ``make mutation``.
"""

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, relative file, original snippet, mutated snippet, tests that must
# kill it).  Snippets must occur exactly once in the file.
MUTANTS = [
    (
        "sghmc-noise-variance-sign",
        "pysgmcmc_tpu/samplers/sghmc.py",
        "2.0 * eps_scaled**2 * self.mdecay * minv_leaf - eps_scaled**4",
        "2.0 * eps_scaled**2 * self.mdecay * minv_leaf + eps_scaled**4",
        ["tests/test_golden_traces.py"],
    ),
    (
        "sghmc-position-update-sign",
        "pysgmcmc_tpu/samplers/sghmc.py",
        "lambda theta, v: theta + v, state.position, momentum",
        "lambda theta, v: theta - v, state.position, momentum",
        ["tests/test_golden_traces.py"],
    ),
    (
        "burnin-tau-increment",
        "pysgmcmc_tpu/samplers/_adaptive.py",
        "lambda tau, g, v_hat: tau + safe_divide(-g * g * tau, v_hat) + 1.0,",
        "lambda tau, g, v_hat: tau + safe_divide(-g * g * tau, v_hat) + 2.0,",
        ["tests/test_golden_traces.py"],
    ),
    (
        "constant-schedule-doubled",
        "pysgmcmc_tpu/stepsize_schedules.py",
        "    def value(self, state, step):\n        return self.initial_value",
        "    def value(self, state, step):\n        return self.initial_value * 2.0",
        ["tests/test_stepsize_schedules.py"],
    ),
    (
        "ess-autocorrelation-factor",
        "pysgmcmc_tpu/diagnostics/sampler_diagnostics.py",
        "tau = 1.0 + 2.0 * jnp.sum(kept)",
        "tau = 1.0 + 1.0 * jnp.sum(kept)",
        ["tests/diagnostics/test_ess_external.py"],
    ),
    (
        "safe-sqrt-unclipped",
        "pysgmcmc_tpu/utils/numeric.py",
        "return jnp.sqrt(jnp.clip(x, clip_value_min, clip_value_max))",
        "return jnp.sqrt(x)",
        ["tests/test_doctests.py::test_doctests[pysgmcmc_tpu.utils.numeric]"],
    ),
    (
        # packed drivers: flip the eps^4 correction in the SGHMC noise
        # variance -- the packed-vs-pytree parity pin must catch it
        "packed-sghmc-noise-sign",
        "pysgmcmc_tpu/parallel/packed.py",
        "2.0 * eps_scaled**2 * mdecay * minv - eps_scaled**4, 1e-16))",
        "2.0 * eps_scaled**2 * mdecay * minv + eps_scaled**4, 1e-16))",
        ["tests/parallel/test_packed.py::"
         "test_lanes_update_matches_pytree_step_bitwise[sghmc]"],
    ),
    (
        # streaming SVGD: drop the last column tile's padding mask, so
        # zero-padded particles attract -- the ragged-n tests must catch it
        "svgd-streaming-unmasked-padding",
        "pysgmcmc_tpu/ops/svgd_streaming.py",
        "            valid_j[None, :], jnp.exp(",
        "            True, jnp.exp(",
        ["tests/test_svgd_streaming.py::test_arbitrary_n_padded_and_masked"],
    ),
    (
        # SGNHT: freeze the Nose-Hoover thermostat at its init value --
        # the Ding et al. noise-absorption property test must catch the
        # dead thermostat
        "sgnht-thermostat-frozen",
        "pysgmcmc_tpu/samplers/sgnht.py",
        "xi = state.xi + eps * (sumsq / d - 1.0)",
        "xi = state.xi + 0.0 * eps * (sumsq / d - 1.0)",
        ["tests/samplers/test_sgnht.py::"
         "test_thermostat_absorbs_gradient_noise"],
    ),
]

COPY = ["pysgmcmc_tpu", "tests", "pytest.ini", "bench.py"]


def run_tests(tree, tests):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    env.pop("PYTEST_ADDOPTS", None)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-x", "-q", "--no-header", "-p",
         "no:cacheprovider", *tests],
        cwd=tree, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def make_tree(tmp, name):
    tree = os.path.join(tmp, name)
    os.makedirs(tree)
    for entry in COPY:
        src = os.path.join(REPO, entry)
        dst = os.path.join(tree, entry)
        if os.path.isdir(src):
            shutil.copytree(
                src, dst,
                ignore=shutil.ignore_patterns("__pycache__", "*.so"))
        else:
            shutil.copy2(src, dst)
    return tree


def main():
    failures = []
    with tempfile.TemporaryDirectory(prefix="pysgmcmc-mutants-") as tmp:
        baseline_tests = sorted({t for *_, tests in MUTANTS for t in tests})
        tree = make_tree(tmp, "baseline")
        result = run_tests(tree, baseline_tests)
        if result.returncode != 0:
            print(result.stdout)
            print("FATAL: baseline (unmutated) tests are not green; "
                  "mutation kills would be meaningless.")
            return 1
        print("baseline green (%d test selections)" % len(baseline_tests))

        for name, rel, original, mutated, tests in MUTANTS:
            tree = make_tree(tmp, name)
            path = os.path.join(tree, rel)
            with open(path) as f:
                source = f.read()
            count = source.count(original)
            if count != 1:
                print("FATAL: mutant %s snippet matched %d times in %s"
                      % (name, count, rel))
                return 1
            with open(path, "w") as f:
                f.write(source.replace(original, mutated))
            result = run_tests(tree, tests)
            killed = result.returncode != 0
            print("%-32s %s" % (name, "KILLED" if killed else "SURVIVED"))
            if not killed:
                failures.append(name)

    if failures:
        print("\n%d mutant(s) SURVIVED — the test suite has holes: %s"
              % (len(failures), ", ".join(failures)))
        return 1
    print("\nmutation score: %d/%d killed" % (len(MUTANTS), len(MUTANTS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
