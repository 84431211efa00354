"""Golden-image regression tests.

Each renderer renders a fixed scene (exact float32 tables, fixed seeds) and
is compared against a checked-in golden rendered by the same code at a
known-good revision.  Any numerical change to the compute path — sampler,
RNG, compositing, camera math — shows up here as a pixel diff.

Regenerate (after an *intentional* change) with:
    python -m tests.test_goldens regenerate
"""

import pathlib

import numpy as np
import jax.numpy as jnp
import pytest

from vpt_jax import transfer, volume
from vpt_jax.renderers import MODULES, make_renderer, make_scene

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
RES = 48
FRAMES = {"mcs": 4, "mcm": 4}


def _scene(tf_srgb=False):
    return make_scene(volume.blobs_volume(24, seed=7),
                      transfer.gray_ramp(alpha_scale=0.9), pack=True,
                      tf_srgb=tf_srgb)


def _render(key, tf_srgb=False):
    r = make_renderer(key, height=RES, width=RES)
    img = r.render_progressive(_scene(tf_srgb), frames=FRAMES.get(key, 2),
                               seed0=11)
    return np.asarray(img, np.float32)


@pytest.mark.parametrize("key", sorted(MODULES))
def test_matches_golden(key):
    path = GOLDEN_DIR / f"{key}.npz"
    if not path.exists():
        pytest.skip(f"golden {path} missing — run regenerate")
    golden = np.load(path)["image"]
    got = _render(key)
    assert got.shape == golden.shape
    # small cross-platform fp slack; goldens are generated on CPU
    assert np.allclose(got, golden, atol=2e-5), (
        key, float(np.abs(got - golden).max()))


def test_matches_golden_tf_srgb():
    """Pin the reference-GL-semantics mode (SRGB8_ALPHA8 TF texture:
    8-bit quantize + sRGB decode, transfer.to_gl_texture) — the tf_srgb
    compute path must stay bit-stable too."""
    path = GOLDEN_DIR / "eam_srgb.npz"
    if not path.exists():
        pytest.skip(f"golden {path} missing — run regenerate")
    golden = np.load(path)["image"]
    got = _render("eam", tf_srgb=True)
    assert np.allclose(got, golden, atol=2e-5), (
        float(np.abs(got - golden).max()))
    # and it must actually differ from the linear-TF golden
    linear = np.load(GOLDEN_DIR / "eam.npz")["image"]
    assert not np.allclose(golden, linear, atol=1e-3)


def regenerate():
    GOLDEN_DIR.mkdir(exist_ok=True)
    for key in sorted(MODULES):
        img = _render(key)
        np.savez_compressed(GOLDEN_DIR / f"{key}.npz", image=img)
        print(f"wrote goldens/{key}.npz  mean={img[..., :3].mean():.4f}")
    img = _render("eam", tf_srgb=True)
    np.savez_compressed(GOLDEN_DIR / "eam_srgb.npz", image=img)
    print(f"wrote goldens/eam_srgb.npz  mean={img[..., :3].mean():.4f}")


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "regenerate":
        regenerate()
