"""Test configuration: run everything on a simulated 8-device CPU mesh.

The distributed tests assert shard-count invariance on a virtual mesh (the
JAX idiom from SURVEY.md §4.4), so the whole suite is hermetic and runs on
the CPU even on a machine with a GPU; chip_smoke.py is the run on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
