"""Differentiable ISO (BASELINE config 1): soft first-crossing depth and
normal gradients — AD must match finite differences, and the τ→0 limit
must recover the hard ISO march."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vpt_jax import transfer, volume
from vpt_jax.renderers import diff_iso, iso, make_scene


@pytest.fixture(scope="module")
def scene():
    return make_scene(volume.sphere_volume(24),
                      transfer.gray_ramp(alpha_scale=1.0), pack=False)


def test_soft_depth_converges_to_hard_iso(scene):
    """Small τ: expected depth ≈ the hard renderer's accumulated
    closest-hit t (within a couple of march steps)."""
    h = w = 24
    hard_params = iso.Params(isovalue=0.4, steps=200)
    state = iso.reset(hard_params, h, w)
    for i in range(8):
        state = iso.render_frame(state, scene, hard_params,
                                 jnp.float32(0.1 * i), jnp.int32(i + 1))
    hard_t = np.asarray(state[..., 3])

    soft = diff_iso.render(
        scene, diff_iso.Params(isovalue=0.4, tau=0.004, steps=200), h, w)
    soft_t = np.asarray(soft["depth"])
    both = (hard_t > 0) & (np.asarray(soft["hit"]) > 0.9)
    assert both.sum() >= 20           # the sphere covers part of the frame
    assert np.abs(soft_t[both] - hard_t[both]).max() < 2.5 / 200


def test_depth_gradient_wrt_isovalue_matches_fd(scene):
    h = w = 12
    base = diff_iso.Params(isovalue=0.45, tau=0.05, steps=64)

    def mean_depth(iso_value):
        p = dataclasses.replace(base, isovalue=iso_value)
        out = diff_iso.render(scene, p, h, w)
        return jnp.mean(out["depth"] * (out["hit"] > 0.5))

    g = float(jax.grad(mean_depth)(jnp.float32(0.45)))
    eps = 1e-3
    fd = (float(mean_depth(jnp.float32(0.45 + eps)))
          - float(mean_depth(jnp.float32(0.45 - eps)))) / (2 * eps)
    assert np.isfinite(g)
    assert abs(g - fd) < 1e-3 + 0.05 * abs(fd)


def test_depth_gradient_wrt_voxels_matches_fd(scene):
    h = w = 8
    params = diff_iso.Params(isovalue=0.45, tau=0.05, steps=48)
    target = jnp.full((h, w), 0.5, jnp.float32)

    def loss(vol_data):
        return diff_iso.depth_loss(vol_data, scene, params, target, h, w)

    vol_data = scene.volume
    g = jax.grad(loss)(vol_data)
    g = np.asarray(g)
    assert np.isfinite(g).all() and np.abs(g).max() > 0

    # FD check on the 3 highest-|grad| voxels
    flat = np.argsort(np.abs(g).ravel())[::-1][:3]
    eps = 1e-3
    for idx in flat:
        z, y, x, c = np.unravel_index(idx, g.shape)
        e = jnp.zeros_like(vol_data).at[z, y, x, c].set(eps)
        fd = (float(loss(vol_data + e)) - float(loss(vol_data - e))) \
            / (2 * eps)
        assert abs(fd - g[z, y, x, c]) < 1e-4 + 0.05 * abs(fd), \
            (fd, g[z, y, x, c])


def test_normals_and_image_are_finite_unit(scene):
    out = diff_iso.render(scene, diff_iso.Params(), 16, 16)
    n = np.asarray(out["normal"])
    assert np.isfinite(n).all()
    norms = np.linalg.norm(n, axis=-1)
    assert np.allclose(norms[np.asarray(out["hit"]) > 0.5], 1.0, atol=1e-3)
    img = np.asarray(out["image"])
    assert np.isfinite(img).all()
    assert img.shape == (16, 16, 4)


def test_normal_gradients_flow_to_voxels(scene):
    """Normals (and thus shading) must be differentiable in the volume."""
    h = w = 8
    params = diff_iso.Params(tau=0.05, steps=32)

    def loss(vol_data):
        sc = dataclasses.replace(scene, volume=vol_data)
        out = diff_iso.render(sc, params, h, w)
        return jnp.sum(out["image"][..., :3] * out["hit"][..., None])

    g = np.asarray(jax.grad(loss)(scene.volume))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
