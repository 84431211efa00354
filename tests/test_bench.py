"""bench.py's measurement plumbing at toy sizes on the CPU (the numbers
themselves come from a run on the card; bench.py refuses any other
backend, tests/test_chip_smoke.py)."""

import sys
from pathlib import Path

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
from vpt_jax import transfer, volume  # noqa: E402
from vpt_jax.renderers import make_scene  # noqa: E402


def test_time_config_counts_events_and_paths():
    scene = make_scene(volume.sphere_volume(16),
                       transfer.gray_ramp(alpha_scale=0.8),
                       pack_dtype=jnp.bfloat16, tf_mxu=True)
    events, paths = bench.time_config(scene, steps=4, frames=2,
                                      height=16, width=16)
    assert events > 0.0
    assert 0.0 <= paths <= events


def test_run_config_row(monkeypatch):
    monkeypatch.setitem(bench.CONFIGS, "toy",
                        (lambda: None, 8, 3, 40.0))
    monkeypatch.setattr(bench, "time_config",
                        lambda scene, steps, frames, extinction:
                        (2.0e8, 1.6e8))
    row = bench.run_config("toy")
    assert row == {"config": "toy", "events_per_s": 200000000,
                   "paths_per_s": 160000000, "mean_path_events": 1.25}


def test_secondary_scenes_toggle_what_they_name(monkeypatch):
    small = volume.sphere_volume
    monkeypatch.setattr(volume, "sphere_volume", lambda n: small(16))
    head = bench.headline_scene()
    exact = bench.exact_scene()
    gather = bench.gather_tf_scene()
    assert head.volume_packed.dtype == jnp.bfloat16
    assert head.transfer_mxu is not None
    assert exact.volume_packed is None and exact.transfer_mxu is None
    assert gather.volume_packed.dtype == jnp.bfloat16
    assert gather.transfer_mxu is None
