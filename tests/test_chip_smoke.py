"""chip_smoke.py's phases at toy sizes on the CPU, and its refusal to pass
without a GPU.  On the CPU the "device" and the host are one backend, so
the device-vs-CPU comparisons are exercised for their plumbing only; the
numbers themselves come from a run on the card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vpt_jax.renderers import MODULES  # noqa: E402


def _cpu_env(tmp_path, **extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env.update(extra)
    return env


@pytest.mark.parametrize("key", sorted(MODULES))
def test_phase_renderers_small(key):
    rows = chip_smoke.phase_renderers(size=16, res=32, timed_frames=1,
                                      check_size=16, check_res=16,
                                      check_frames=2, keys=[key])
    assert rows[key]["ms_per_frame"] > 0.0
    assert rows[key]["fast_vs_exact"] <= chip_smoke.FAST_TOL


def test_phase_serve_small():
    out = chip_smoke.phase_serve(size=16, res=32)
    assert len(out["continuation_s"]) == 2
    assert out["first_image_s"] > 0.0


def test_phase_capacity_small():
    out = chip_smoke.phase_capacity(size=16, res=16)
    # 16^3 rows of 8 bf16 corners
    assert out["table_gib"] == pytest.approx(16 ** 3 * 8 * 2 / 2 ** 30)


def test_phase_fit_small():
    out = chip_smoke.phase_fit(size=16, res=16, frames=2, steps=2,
                               target_frames=4, check_size=8, check_res=8)
    assert out["grad_rel_l2"] <= chip_smoke.GRAD_RTOL
    assert out["s_per_step"] > 0.0


def test_phase_four_cards_virtual():
    # conftest.py provides 8 virtual CPU devices; the phase takes 4
    out = chip_smoke.phase_four_cards(n_devices=4, dp_size=16, dp_res=32,
                                      sp_size=16, sp_res=32, train_size=16,
                                      train_res=16)
    assert out["eam_grad_max_abs"] >= 0.0


def test_shard_diff_counts_mismatches():
    import numpy as np

    ref = {k: np.zeros((4, 4)) for k in ("samples", "bounces")}
    ref.update({k: np.zeros((4, 4, 3)) for k in (
        "position", "direction", "transmittance", "radiance")})
    got = {k: v.copy() for k, v in ref.items()}
    got["samples"][1, 2] = 1.0
    got["radiance"][0, 0, 1] = 3e-7
    assert chip_smoke._shard_diff(ref, got) == (1, pytest.approx(3e-7))


def test_rng_streams_match_small():
    assert chip_smoke.rng_streams_match(8)


def test_main_refuses_cpu(tmp_path):
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=tmp_path, env=_cpu_env(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "'cpu'" in proc.stderr


def test_alone_without_repo_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _cpu_env(tmp_path)
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_bench_refuses_cpu(tmp_path):
    proc = subprocess.run([sys.executable, str(ROOT / "bench.py")],
                          cwd=tmp_path, env=_cpu_env(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "'cpu'" in proc.stderr
    assert proc.stdout.strip() == ""
