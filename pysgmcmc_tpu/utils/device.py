"""Device checks and compile-cache placement for the GPU entry points.

``bench.py`` and ``chip_smoke.py`` measure or check the program on a GPU.
They must fail, not fall back to the CPU, when JAX finds no GPU, and every
result they print names the device it came from.  Both keep JAX's
persistent compilation cache at one fixed place, so repeated runs reuse
compiled programs: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads
it itself), otherwise ``<repo>/.jax_cache``.

Examples
--------
>>> compile_cache_dir("/repo/.jax_cache", environ={})
'/repo/.jax_cache'
>>> compile_cache_dir("/repo/.jax_cache",
...                   environ={"JAX_COMPILATION_CACHE_DIR": "/cache"})
'/cache'
"""

import os
import subprocess

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(default_dir, environ=None):
    """The compile-cache directory: ``$JAX_COMPILATION_CACHE_DIR`` if set,
    else ``default_dir`` (an absolute, fixed path)."""
    environ = os.environ if environ is None else environ
    return environ.get(CACHE_ENV) or os.path.abspath(default_dir)


def enable_compile_cache(default_dir):
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory.

    With the variable set JAX already uses it, and nothing is changed."""
    path = compile_cache_dir(default_dir)
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """Return ``jax.devices()`` if they are GPUs; raise otherwise."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            "no GPU: JAX's default devices are {!r}; this entry point "
            "measures the GPU and does not fall back to {}".format(
                devices, devices[0].platform)
        )
    return devices


def device_record(devices):
    """The device fields every result line carries."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def nvidia_smi_name_and_power_limit():
    """``name, power.limit`` of each card, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
