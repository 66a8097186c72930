#!/usr/bin/env bash
# Fast/full test split, mirroring the reference's CI layout
# (/root/reference/ci_scripts/run_tests.sh: full BNN end-to-end tests run
# only in the daily cron, the fast suite on every push).
#
# fast: excludes @pytest.mark.slow (statistical, KS, long-scan and BNN
#       end-to-end tests).  The tail is one-off XLA compiles spread over
#       ~300 tests, not test workloads — so the persistent JAX compilation
#       cache below (with the min-compile-time threshold dropped to 0 so
#       sub-second compiles cache too) recovers most of it on every
#       rerun.  --durations=10 keeps drift visible.
# full: the whole suite, then every example under examples/ (the analog of
#       the reference's nbval notebook run, pysgmcmc/Makefile:10-14).
#
# Tests run on the CPU (8 virtual devices).  The GPU is exercised by
# `python chip_smoke.py` and `python bench.py` on a machine with one.
set -euo pipefail
cd "$(dirname "$0")/.."

export JAX_PLATFORMS=cpu
case "${XLA_FLAGS:-}" in
  *xla_force_host_platform_device_count*) ;;
  *) export XLA_FLAGS="${XLA_FLAGS:-} --xla_force_host_platform_device_count=8" ;;
esac

# Persistent XLA compilation cache: the fast lane's tail is one-off
# compiles, so warm reruns (the common CI case: every push after the
# first) skip them.  Works on the CPU backend; cold runs are unaffected.
export JAX_COMPILATION_CACHE_DIR="${JAX_COMPILATION_CACHE_DIR:-$PWD/.jax_cache}"
export JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES=-1
# 0, not 0.5: the fast lane's tail is ~300 sub-second compiles; at the
# default threshold none of them were ever cached (measured: caching
# them shaves ~25% off the warm lane on the single-core CI env)
export JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS=0

MODE="${1:-fast}"

if [ "$MODE" = "full" ]; then
    python -m pytest tests/ -q
    make examples
    make figures
    # executed docs: the getting-started page runs its cells live, so a
    # full run fails if the narrative drifts from the API
    make docs
    # Mutation harness last: refactors that stale its snippets or blunt
    # its kills must break CI here, not rot silently.
    make mutation
elif [ "$MODE" = "cov" ]; then
    # fast lane + statement coverage (the reference CI's --cov analog,
    # pysgmcmc/pytest.ini:2; implemented on sys.monitoring — ci/coverage.py)
    PYSGMCMC_COVERAGE=1 python -m pytest tests/ -q -m "not slow"
else
    python -m pytest tests/ -q -m "not slow" --durations=10
fi
