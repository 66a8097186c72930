# Development targets (counterpart of the reference's Makefile:
# /root/reference/pysgmcmc/Makefile — test/doc/notebook targets).

PYTEST ?= python -m pytest

.PHONY: test test-fast coverage examples docs figures smoke bench mutation clean

test:
	$(PYTEST) tests/ -q

test-fast:
	$(PYTEST) tests/ -q -x -m "not slow"

# Statement coverage (the reference CI's --cov, pysgmcmc/pytest.ini:2),
# implemented dependency-free on sys.monitoring — see ci/coverage.py.
coverage:
	bash ci/run_tests.sh cov

# Executable documentation (the reference runs its notebooks via nbval;
# ci/run_tests.sh full mode runs this target).
examples:
	PYTHONPATH=. JAX_PLATFORMS=cpu python examples/api_quickstart.py
	PYTHONPATH=. JAX_PLATFORMS=cpu python examples/svgd_mixture.py
	PYTHONPATH=. JAX_PLATFORMS=cpu python examples/relativistic_sghmc_banana.py
	PYTHONPATH=. JAX_PLATFORMS=cpu python examples/bnn_sinc.py
	PYTHONPATH=. JAX_PLATFORMS=cpu python examples/bayesian_optimization.py
	PYTHONPATH=. JAX_PLATFORMS=cpu python examples/checkpoint_resume.py
	PYTHONPATH=. JAX_PLATFORMS=cpu python examples/arviz_export.py
	PYTHONPATH=. JAX_PLATFORMS=cpu python examples/compute_ess.py banana \
	    --stepsize 0.5 --n-chains 2 --samples-per-chain 500 \
	    -o /tmp/ess_banana_ci.json

# Generated HTML API documentation (the counterpart of the reference's
# Sphinx tree, /root/reference/docs/source/api.rst) — one page per module
# from the package docstrings, whose examples the doctest suite executes.
docs:
	PYTHONPATH=. JAX_PLATFORMS=cpu python docs/gen_api_docs.py
	PYTHONPATH=. JAX_PLATFORMS=cpu python docs/gen_getting_started.py
	PYTHONPATH=. JAX_PLATFORMS=cpu python docs/gen_notebooks.py

# Result figure (the analog of the reference's executed-notebook plot of
# the RSGHMC banana reproduction), rendered from a live CPU banana chain.
figures:
	PYTHONPATH=. JAX_PLATFORMS=cpu python docs/gen_figures.py

# On a machine with a GPU: the smoke check, then the benchmark.
smoke:
	python chip_smoke.py

bench:
	python bench.py

# Mutation-testing analog (the reference's cosmic-ray target was never
# wired up, /root/reference/pysgmcmc/Makefile:26-28; this one runs):
# curated single-line mutants of the load-bearing numerics, each of which
# must be killed by a targeted test selection.
mutation:
	python ci/mutation_check.py

clean:
	find . -name __pycache__ -type d -exec rm -rf {} +
	rm -rf .pytest_cache docs/_build
