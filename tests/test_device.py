"""Accelerator set-up helpers (vpt_jax/runtime/device.py): the persistent
compile cache's location, the GPU requirement and the device report."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from vpt_jax.runtime import device

ROOT = Path(__file__).resolve().parent.parent

_PROBE = ("import jax\n"
          "from vpt_jax.runtime.device import enable_compile_cache\n"
          "print(enable_compile_cache())\n"
          "print(jax.config.jax_compilation_cache_dir)\n"
          "jax.jit(lambda x: x * 2 + 1)(1.0).block_until_ready()\n")


def _probe(tmp_path, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0", **env_extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


def test_compile_cache_follows_env_var(tmp_path):
    cache = tmp_path / "cache"
    used, configured = _probe(tmp_path,
                              JAX_COMPILATION_CACHE_DIR=str(cache))
    assert used == configured == str(cache)
    assert any(cache.iterdir())          # the compiled entry landed there


def test_compile_cache_default_is_fixed_repo_path(tmp_path):
    first = _probe(tmp_path)
    second = _probe(tmp_path)
    assert first == second == [str(ROOT / ".jax_cache")] * 2


def test_compile_cache_dir_is_ignored_by_git():
    lines = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def test_require_gpu_names_the_backend():
    with pytest.raises(SystemExit, match="'cpu'"):
        device.require_gpu()


def test_device_summary_fields():
    info = device.device_summary()
    assert info["platform"] == "cpu"
    assert info["count"] >= 1
    assert isinstance(info["kind"], str)


def test_card_report_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert device.card_report().startswith("nvidia-smi unavailable")
