"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Sharding tests run against 8 virtual CPU devices (the standard JAX recipe
for testing ``Mesh``/``shard_map`` code without several accelerators).
``JAX_PLATFORMS`` defaults to ``cpu``.  The card-only tests are marked
``gpu`` and take the ``gpu`` fixture; ``chip_smoke.py`` runs them inside its
own process, whose JAX already drives the GPU (the settings below then
change nothing).
"""

import os
import sys

if os.environ.get("PYSGMCMC_COVERAGE"):
    # Statement coverage via ci/coverage.py (the reference CI's --cov
    # analog; see that module's docstring).  Started before any
    # pysgmcmc_tpu import so import-time lines count.
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "ci"))
    import coverage as _pysgmcmc_coverage

    _pysgmcmc_coverage.start(
        os.path.join(os.path.dirname(__file__), "..", "pysgmcmc_tpu")
    )

    def pytest_sessionfinish(session, exitstatus):
        results = _pysgmcmc_coverage.collect(
            os.path.join(os.path.dirname(__file__), "..", "pysgmcmc_tpu")
        )
        out = os.environ.get("PYSGMCMC_COVERAGE_JSON", ".coverage.json")
        _pysgmcmc_coverage.write_json(results, out)
        _pysgmcmc_coverage.report(results)


_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The GPU devices; skips the test where JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU: run by chip_smoke.py on the card")
    return devices
