"""Accelerator set-up shared by the entry points (CLI, bench, chip smoke):
the persistent compile cache, the GPU requirement of every measurement,
and the device report printed beside every number."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

#: fixed cache location when the environment names none; a stable path is
#: part of what makes a later process find the entries again
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and left
    alone; otherwise the cache goes to ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def require_gpu() -> None:
    """Exit nonzero, naming the backend found, unless JAX runs on a GPU.
    JAX falls back to the CPU when its CUDA plugin fails to load, and a
    measurement taken on that fallback must not pass for a GPU one."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"needs a GPU, but JAX's backend is {backend!r}")


def card_report() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them (a
    card set below its maximum power runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def device_summary() -> dict:
    """The device fields every result names: platform, kind, count."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
