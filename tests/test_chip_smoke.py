"""The GPU entry points refuse to run without a GPU, and place the
compile cache where the environment or the repository says."""

import os
import shutil
import subprocess
import sys
import tempfile

import jax
import pytest

from pysgmcmc_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ, expected", [
    ({}, "/repo/.jax_cache"),
    ({"JAX_COMPILATION_CACHE_DIR": "/shared/cache"}, "/shared/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, "/repo/.jax_cache"),
], ids=["unset", "set", "empty"])
def test_compile_cache_dir(environ, expected):
    assert device.compile_cache_dir("/repo/.jax_cache", environ) == expected


def test_compile_cache_dir_is_fixed_not_temporary(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    default = os.path.join(REPO, ".jax_cache")
    first = device.compile_cache_dir(default)
    assert first == device.compile_cache_dir(default) == default
    assert not first.startswith(tempfile.gettempdir())
    # relative defaults resolve against the working directory, once
    assert os.path.isabs(device.compile_cache_dir(".jax_cache"))


def test_enable_compile_cache_leaves_env_choice(monkeypatch):
    updates = []
    monkeypatch.setattr(
        device.jax.config, "update", lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/shared/cache")
    assert device.enable_compile_cache("/repo/.jax_cache") == "/shared/cache"
    assert updates == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert device.enable_compile_cache("/repo/.jax_cache") == \
        "/repo/.jax_cache"
    assert updates == [("jax_compilation_cache_dir", "/repo/.jax_cache")]


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_device_record_fields():
    record = device.device_record(jax.devices())
    assert record == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                      "count": len(jax.devices())}


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """On a CPU-only machine, and in a directory holding chip_smoke.py and
    nothing else of the repository, the script exits non-zero and prints
    no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = _run(str(script), str(cwd))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
