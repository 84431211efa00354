"""Occupied-interval march clamp (make_scene(march_clamp=True)): the
opt-in empty-space acceleration for the march renderers,
validated against the exact machine the way pack_dtype=bf16 is — exact
no-op on dense scenes, quadrature-equivalent on sparse ones."""

import numpy as np
import jax.numpy as jnp
import pytest

from vpt_jax import skipgrid, transfer, volume
from vpt_jax.renderers import depth, eam, make_scene, mip


def _sparse_tf():
    """Gray ramp with an exactly-zero alpha floor (value 0 → invisible)."""
    tf = np.asarray(transfer.gray_ramp(alpha_scale=0.8)).copy()
    tf[:, :8, 3] = 0.0
    return jnp.asarray(tf)


def _ball(n=32, r=0.15):
    g = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    r2 = (g[:, None, None] ** 2 + g[None, :, None] ** 2
          + g[None, None, :] ** 2)
    return jnp.asarray(np.where(r2 < r * r, 0.9, 0.0)
                       .astype(np.float32)[..., None])


# ---------------------------------------------------------------------------
# The AABB derivation itself
# ---------------------------------------------------------------------------

def test_occupied_aabb_known_extent():
    """A slab of nonzero voxels at x ∈ [4, 7] makes cells x ∈ [3, 7]
    occupied (cell x includes corner x+1), so the box must cover
    [(3+0.5)/16, (7+1.5)/16] on x and the full [0, 1] on y/z (their
    occupied cells reach the volume faces)."""
    v = np.zeros((16, 16, 16, 1), np.float32)
    v[:, :, 4:8] = 0.9
    aabb = np.asarray(skipgrid.occupied_aabb(jnp.asarray(v), _sparse_tf()))
    assert aabb.shape == (2, 3)
    np.testing.assert_allclose(aabb[0], [3.5 / 16, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(aabb[1], [8.5 / 16, 1.0, 1.0], atol=1e-6)


def test_occupied_aabb_dense_scene_is_none():
    """No TF-empty cell → None: the clamp must not touch the exact path."""
    assert skipgrid.occupied_aabb(
        volume.sphere_volume(16).data,
        transfer.gray_ramp(alpha_scale=0.8)) is None


def test_occupied_aabb_invisible_volume_degenerate():
    v = jnp.zeros((8, 8, 8, 1), jnp.float32)
    aabb = np.asarray(skipgrid.occupied_aabb(v, _sparse_tf()))
    assert np.all(aabb[0] == aabb[1])       # every ray misses


def test_make_scene_dense_clamp_is_bitwise_noop():
    params = eam.Params(extinction=60.0, slices=32)
    kw = dict(camera=None)
    sc0 = make_scene(volume.sphere_volume(16),
                     transfer.gray_ramp(alpha_scale=0.8), **kw)
    sc1 = make_scene(volume.sphere_volume(16),
                     transfer.gray_ramp(alpha_scale=0.8),
                     march_clamp=True, **kw)
    assert sc1.occupied_aabb is None
    f0 = np.asarray(eam.generate(sc0, params, jnp.float32(0.3), 24, 24))
    f1 = np.asarray(eam.generate(sc1, params, jnp.float32(0.3), 24, 24))
    assert np.array_equal(f0, f1)


def test_make_scene_multichannel_warns_and_skips():
    v = jnp.zeros((8, 8, 8, 2), jnp.float32)
    with pytest.warns(UserWarning, match="march_clamp"):
        sc = make_scene(v, _sparse_tf(), march_clamp=True)
    assert sc.occupied_aabb is None


# ---------------------------------------------------------------------------
# Quadrature equivalence on a sparse scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    exact = make_scene(_ball(), _sparse_tf())
    clamp = make_scene(_ball(), _sparse_tf(), march_clamp=True)
    assert clamp.occupied_aabb is not None
    box = np.asarray(clamp.occupied_aabb)
    # the ball has diameter 0.3: the box must be tight around it (cells
    # dilate by one voxel for trilinear support)
    assert np.all(box[0] > 0.25) and np.all(box[1] < 0.75)
    return exact, clamp


def test_eam_clamp_matches_exact_quadrature(scenes):
    """Same integral, refined quadrature: at a high slice count the
    clamped and exact marches agree, and at a LOW slice count the clamp
    is strictly closer to the converged reference."""
    exact, clamp = scenes
    h = w = 24

    def frame(sc, slices):
        p = eam.Params(extinction=80.0, slices=slices, random=False)
        return np.asarray(eam.generate(sc, p, jnp.float32(0.0), h, w))

    ref = frame(exact, 2048)
    hi_e, hi_c = frame(exact, 512), frame(clamp, 512)
    assert np.allclose(hi_e, hi_c, atol=3e-3)
    lo_e, lo_c = frame(exact, 16), frame(clamp, 16)
    rmse_e = float(np.sqrt(np.mean((lo_e - ref) ** 2)))
    rmse_c = float(np.sqrt(np.mean((lo_c - ref) ** 2)))
    # the whole point: the clamp's 16 slices act like ~3x the density
    assert rmse_c < 0.5 * rmse_e, (rmse_c, rmse_e)


def test_mip_clamp_matches_exact(scenes):
    exact, clamp = scenes
    h = w = 24
    p = mip.Params(steps=256)
    f_e = np.asarray(mip.generate(exact, p, jnp.float32(0.3), h, w))
    f_c = np.asarray(mip.generate(clamp, p, jnp.float32(0.3), h, w))
    assert np.allclose(f_e, f_c, atol=2e-2)
    assert f_c.max() > 0.1                  # the ball is actually seen


def test_depth_clamp_matches_exact(scenes):
    """Depth reports an ABSOLUTE ray parameter: the clamped march must
    agree with the exact one (both quantize the crossing by their own
    step, so tolerance is a couple of the coarser steps)."""
    exact, clamp = scenes
    h = w = 24
    p = depth.Params(extinction=200.0, slices=512, threshold=0.1,
                     random=False)
    f_e = np.asarray(depth.generate(exact, p, jnp.float32(0.0), h, w))
    f_c = np.asarray(depth.generate(clamp, p, jnp.float32(0.0), h, w))
    hit = (f_e >= 0) | (f_c >= 0)
    # same hit/miss classification pixel for pixel
    assert np.array_equal(f_e >= 0, f_c >= 0)
    assert np.allclose(f_e[hit], f_c[hit], atol=0.02)


def test_iso_value_aabb_threshold_tightens():
    """The value-threshold box must shrink as the alpha
    floor rises: a radially decaying ball reaches high alpha only near
    its center."""
    n = 32
    g = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    r2 = (g[:, None, None] ** 2 + g[None, :, None] ** 2
          + g[None, None, :] ** 2)
    v = jnp.asarray(np.clip(1.0 - r2 / 0.09, 0.0, 1.0)
                    .astype(np.float32)[..., None])
    tf = _sparse_tf()
    lo = np.asarray(skipgrid.iso_value_aabb(v, tf, 0.05))
    hi = np.asarray(skipgrid.iso_value_aabb(v, tf, 0.6))
    assert np.all(hi[0] >= lo[0]) and np.all(hi[1] <= lo[1])
    assert np.any(hi[0] > lo[0] + 1e-6)
    # a floor every cell can reach returns None (clamp would be useless)
    assert skipgrid.iso_value_aabb(
        jnp.full((8, 8, 8, 1), 0.9, jnp.float32),
        transfer.gray_ramp(alpha_scale=0.9), 0.1) is None


def test_iso_clamp_matches_exact(scenes):
    """ISO under march_clamp: same hit classification and hit positions
    as the exact machine at a high step count (both quantize the crossing
    by their own backward step)."""
    from vpt_jax.renderers import iso

    exact, clamp = scenes
    h = w = 24
    p = iso.Params(isovalue=0.3, steps=512)
    f_e = np.asarray(iso.generate(exact, p, jnp.float32(0.0), h, w))
    f_c = np.asarray(iso.generate(clamp, p, jnp.float32(0.0), h, w))
    hit_e, hit_c = f_e[..., 3] > 0, f_c[..., 3] > 0
    assert np.array_equal(hit_e, hit_c)
    assert hit_e.any()
    # positions agree to a couple of the quantization steps
    assert np.allclose(f_e[hit_e][:, :3], f_c[hit_c][:, :3], atol=0.02)


def test_iso_clamp_zero_isovalue_falls_back_exact(scenes):
    """isovalue ≤ 0 makes every sample a hit — the clamp box is NOT
    hit-free there, so the in-graph guard must fall back to the full
    segment bitwise."""
    from vpt_jax.renderers import iso

    exact, clamp = scenes
    h = w = 24
    p = iso.Params(isovalue=0.0, steps=64)
    f_e = np.asarray(iso.generate(exact, p, jnp.float32(0.2), h, w))
    f_c = np.asarray(iso.generate(clamp, p, jnp.float32(0.2), h, w))
    np.testing.assert_array_equal(f_e, f_c)


def test_iso_tighter_box_guarded_by_floor():
    """iso_clamp_min builds the tighter box; below the floor the machine
    falls back to the occupied box (still exact for isovalue > 0)."""
    from vpt_jax.renderers import iso

    sc0 = make_scene(_ball(), _sparse_tf())
    sc1 = make_scene(_ball(), _sparse_tf(), march_clamp=True,
                     iso_clamp_min=0.5)
    assert sc1.iso_aabb is not None
    box_occ = np.asarray(sc1.occupied_aabb)
    box_iso = np.asarray(sc1.iso_aabb)
    assert np.all(box_iso[0] >= box_occ[0] - 1e-6)
    assert np.all(box_iso[1] <= box_occ[1] + 1e-6)
    h = w = 24
    for isovalue in (0.7, 0.3):    # above and below the floor
        p = iso.Params(isovalue=isovalue, steps=512)
        f_e = np.asarray(iso.generate(sc0, p, jnp.float32(0.0), h, w))
        f_c = np.asarray(iso.generate(sc1, p, jnp.float32(0.0), h, w))
        assert np.array_equal(f_e[..., 3] > 0, f_c[..., 3] > 0), isovalue
        hit = f_e[..., 3] > 0
        assert np.allclose(f_e[hit][:, :3], f_c[hit][:, :3],
                           atol=0.02), isovalue


def test_clamp_miss_semantics(scenes):
    """Rays through the cube that miss the occupied box must produce the
    renderer's background output, exactly as the exact machine's empty
    march does: EAM (0,0,0,1), MIP 0, depth −1."""
    exact, clamp = scenes
    h = w = 24                 # corner pixels cross the cube, miss the ball
    pe = eam.Params(extinction=80.0, slices=64, random=False)
    fe = np.asarray(eam.generate(exact, pe, jnp.float32(0.0), h, w))
    fc = np.asarray(eam.generate(clamp, pe, jnp.float32(0.0), h, w))
    np.testing.assert_array_equal(fc[0, 0], fe[0, 0])
    pd = depth.Params(extinction=200.0, slices=64, threshold=0.1)
    dc = np.asarray(depth.generate(clamp, pd, jnp.float32(0.0), h, w))
    assert dc[0, 0] == -1.0
