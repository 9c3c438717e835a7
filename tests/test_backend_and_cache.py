"""Backend choice by platform, the compile-cache location, and what the
served path imports.

The engine runs the kernel on a GPU at float32 and the XLA scan on the CPU;
any other platform is an error rather than a silent fallback. The compile
cache lives where ``JAX_COMPILATION_CACHE_DIR`` says or, without it, in the
checkout's ``.jax_cache``. The engine and the payload builder import
neither pydantic, pandas, aiohttp nor matplotlib.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from monte_carlo_retirement_tpu.engine import runner
from monte_carlo_retirement_tpu.engine.runner import auto_backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,dtype,with_mesh,expected",
    [
        ("gpu", jnp.float32, False, "pallas"),
        ("gpu", jnp.float32, True, "pallas_sharded"),
        ("gpu", jnp.float64, False, "scan"),
        ("cpu", jnp.float32, False, "scan"),
        ("cpu", jnp.float32, True, "scan"),
        ("cpu", jnp.float64, False, "scan"),
    ],
)
def test_auto_backend_by_platform(platform, dtype, with_mesh, expected):
    mesh = object() if with_mesh else None
    assert auto_backend(dtype, mesh, platform=platform) == expected


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_auto_backend_rejects_other_platforms(platform):
    with pytest.raises(RuntimeError, match="unsupported platform"):
        auto_backend(jnp.float32, platform=platform)


def test_auto_backend_reads_the_running_platform():
    assert auto_backend(jnp.float32) == "scan"  # the tests run on the CPU


def _record_config_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(runner, "_CACHE_READY", False)
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.__setitem__(name, value)
    )
    return calls


def test_cache_dir_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config_updates(monkeypatch)
    runner.enable_persistent_compilation_cache()
    want = os.path.join(REPO, ".jax_cache")
    assert runner.default_cache_dir() == want
    assert calls["jax_compilation_cache_dir"] == want
    assert os.path.isdir(want)


def test_cache_dir_from_the_environment_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_config_updates(monkeypatch)
    runner.enable_persistent_compilation_cache()
    assert "jax_compilation_cache_dir" not in calls
    assert runner._CACHE_READY


_BLOCKED_IMPORT = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
import monte_carlo_retirement_tpu.engine.runner
import monte_carlo_retirement_tpu.hosts.payload
import monte_carlo_retirement_tpu.search.driver
from monte_carlo_retirement_tpu.config import Config, load_config_from_json
Config(**load_config_from_json({config!r}))
print("imported")
"""


def test_served_path_imports_no_optional_packages():
    """With pydantic, pandas, aiohttp and matplotlib blocked, the engine,
    the search driver, the Config and the payload builder still import."""
    code = _BLOCKED_IMPORT.format(
        blocked=("pydantic", "pandas", "aiohttp", "matplotlib"),
        repo=REPO,
        config=os.path.join(REPO, "config.json"),
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported" in out.stdout


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, env=env, timeout=300,
    )


def test_chip_smoke_fails_without_a_gpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone_outside_the_repo(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
