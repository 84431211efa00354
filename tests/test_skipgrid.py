"""Super-voxel majorant tracking (vpt_jax/skipgrid.py) — correctness.

The majorant grid is an acceleration with no reference
counterpart; its contract is: (a) per-cell majorants conservatively bound
the TF alpha anywhere in the cell's trilinear support (non-monotone TFs
included), (b) boundary hops never overshoot the majorant's validity, and
(c) the accelerated estimator converges to the exact machine's image — it
is the same null-collision estimator with a rescaled (local) majorant."""

import jax.numpy as jnp
import numpy as np

from vpt_jax import skipgrid, transfer, volume
from vpt_jax.renderers import make_renderer, make_scene


def _sphere_scene(n=32, majorant_grid=None, alpha_scale=1.0):
    vol = volume.sphere_volume(n)
    tf = transfer.gray_ramp(alpha_scale=alpha_scale)
    return make_scene(vol, tf, majorant_grid=majorant_grid)


def test_build_shapes_and_gating():
    tf = transfer.gray_ramp()
    grid = skipgrid.build_majorant_grid(
        jnp.ones((16, 16, 16, 1), jnp.float32), tf, 4)
    assert grid.shape == (4, 4, 4, 2)
    # multi-channel volumes: unsupported
    assert skipgrid.build_majorant_grid(
        jnp.ones((8, 8, 8, 2), jnp.float32), tf, 4) is None
    # non-divisible dims: unsupported
    assert skipgrid.build_majorant_grid(
        jnp.ones((12, 12, 12, 1), jnp.float32), tf, 5) is None
    # make_scene silently ignores an impossible grid
    sc = make_scene(jnp.ones((8, 8, 8, 2), jnp.float32), tf,
                    majorant_grid=4)
    assert sc.majorant is None


def test_build_exact_zero_alpha_distance_field():
    """A TF with exact zeros below a threshold yields empty cells with a
    growing Chebyshev distance field."""
    vol = np.zeros((16, 16, 16, 1), np.float32)
    vol[12:16] = 1.0                       # occupied top z-slab
    tf = np.zeros((2, 256, 4), np.float32)
    tf[:, 128:, 3] = 0.5                   # alpha only for values >= ~0.5
    grid = np.asarray(skipgrid.build_majorant_grid(
        jnp.asarray(vol), jnp.asarray(tf), 4))
    maxalpha, dist = grid[..., 0], grid[..., 1]
    assert np.all(maxalpha[3] == 0.5)      # occupied slab
    assert np.all(dist[3] == 0.0)
    # cell 2's dilated support touches voxel 12 -> occupied too
    assert np.all(maxalpha[2] == 0.5) and np.all(dist[2] == 0.0)
    assert np.all(maxalpha[:2] == 0.0)     # far empty slabs
    assert np.all(dist[1] == 1.0) and np.all(dist[0] == 2.0)


def test_nonmonotone_tf_value_range_is_conservative():
    """A cell whose corner values straddle a TF alpha bump must get a
    non-zero majorant even when alpha at every corner value is zero
    (interpolated values pass through the bump)."""
    vol = np.zeros((8, 8, 8, 1), np.float32)
    vol[4:] = 1.0          # cells on the boundary interpolate through 0.5
    tf = np.zeros((2, 256, 4), np.float32)
    tf[:, 120:136, 3] = 1.0  # alpha bump at value ~0.5 only
    grid = np.asarray(skipgrid.build_majorant_grid(
        jnp.asarray(vol), jnp.asarray(tf), 4))
    maxalpha = grid[..., 0]
    # z-cells 1 and 2 contain the 0/1 boundary (dilated support) -> bump
    assert np.all(maxalpha[1:3] == 1.0)
    # cells far from the boundary never produce values near the bump
    assert np.all(maxalpha[0] == 0.0) and np.all(maxalpha[3] == 0.0)


def test_majorant_bounds_sampled_alpha():
    """Conservativeness invariant: for any position, the interpolated TF
    alpha never exceeds the cell majorant at that position."""
    sc = _sphere_scene(32, majorant_grid=8)
    assert sc.majorant is not None
    rng = np.random.default_rng(5)
    pos = jnp.asarray(rng.uniform(0, 1, (8192, 3)).astype(np.float32))
    n = sc.majorant.shape[0]
    cell = jnp.clip((pos * n).astype(jnp.int32), 0, n - 1)
    flat = (cell[..., 2] * n + cell[..., 1]) * n + cell[..., 0]
    mu = np.asarray(jnp.take(sc.majorant.reshape(-1, 2), flat,
                             axis=0))[..., 0]
    alpha = np.asarray(sc.sample_color(pos)[..., 3])
    assert np.all(alpha <= mu + 1e-6)


def test_flight_step_bounds_stay_in_cell():
    """t_bound from flight_step never leaves the current cell except
    through exactly-empty space (multi-cell hops), so the majorant is
    valid along the whole flight."""
    sc = _sphere_scene(32, majorant_grid=8)
    n = sc.majorant.shape[0]
    rng = np.random.default_rng(7)
    pos = jnp.asarray(rng.uniform(0, 1, (4096, 3)).astype(np.float32))
    dirs = rng.normal(size=(4096, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = jnp.asarray(dirs)
    mu, t_bound = skipgrid.flight_step(sc.majorant, pos, dirs)
    mu, t_bound = np.asarray(mu), np.asarray(t_bound)
    assert np.all(t_bound >= 0.0)
    # sample alpha densely along each flight; it must never exceed mu
    frac = jnp.linspace(0.0, 1.0, 17)
    pts = pos[:, None, :] + (jnp.asarray(t_bound)[:, None]
                             * frac[None, :])[..., None] * dirs[:, None, :]
    alpha = np.asarray(sc.sample_color(pts)[..., 3])
    inside = np.asarray(jnp.all((pts >= 0) & (pts <= 1), axis=-1))
    bad = alpha > mu[:, None] + 1e-6
    assert not np.any(bad & inside)


def test_majorant_mode_converges_to_exact_image():
    """The local-majorant machine must converge to the exact machine's
    image (different RNG consumption -> compare converged means)."""
    from vpt_jax.renderers import mcm

    n = 12
    params = mcm.Params(extinction=30.0, anisotropy=0.0, steps=16)
    imgs = {}
    for key, grid in (("exact", None), ("majorant", 8)):
        sc = _sphere_scene(32, majorant_grid=grid)
        r = make_renderer("mcm", params=params, height=n, width=n)
        imgs[key] = np.asarray(r.render_progressive(sc, frames=150,
                                                    seed0=3))
    assert np.abs(imgs["exact"] - imgs["majorant"]).max() < 0.12
    assert np.abs(imgs["exact"].mean() - imgs["majorant"].mean()) < 0.02


def test_majorant_homogeneous_analytic():
    """Homogeneous absorbing medium: with maxalpha == alpha everywhere the
    local machine has no null collisions at all; the converged center
    pixel still estimates exp(-sigma*L) (cf. test_mcm_homogeneous_unbiased)."""
    from vpt_jax.renderers import mcm

    n = 9
    vol = volume.Volume(jnp.ones((8, 8, 8, 1), jnp.float32))
    tf = np.zeros((2, 256, 4), np.float32)
    tf[..., 3] = 0.4
    sc = make_scene(vol, jnp.asarray(tf), majorant_grid=4)
    assert sc.majorant is not None
    assert np.allclose(np.asarray(sc.majorant[..., 0]), 0.4)
    params = mcm.Params(extinction=4.0, anisotropy=0.0, steps=64)
    r = make_renderer("mcm", params=params, height=n, width=n)
    img = np.asarray(r.render_progressive(sc, frames=100, seed0=7))
    center = img[n // 2, n // 2, 0]
    assert abs(center - np.exp(-1.6)) < 0.1


def test_majorant_mode_makes_progress_faster():
    """On a sparse scene the local-majorant machine completes more paths
    per iteration budget (the whole point)."""
    from vpt_jax.renderers import mcm

    # a small dense ball in a mostly-empty cube (the CT-like regime)
    g = (np.arange(32) + 0.5) / 32 - 0.5
    r2 = (g[:, None, None] ** 2 + g[None, :, None] ** 2
          + g[None, None, :] ** 2)
    vol = jnp.asarray(np.where(r2 < 0.15 ** 2, 0.9, 0.0)
                      .astype(np.float32)[..., None])
    tf = transfer.gray_ramp(alpha_scale=0.5)
    params = mcm.Params(extinction=60.0, steps=32)
    done = {}
    for key, grid in (("exact", None), ("majorant", 8)):
        sc = make_scene(vol, tf, majorant_grid=grid)
        s = mcm.reset(params, 16, 16, sc)
        for i in range(3):
            s = mcm.render_frame(s, sc, params, jnp.float32(0.5 + i),
                                 jnp.int32(i + 1))
        # center pixels actually track through the volume (edge rays miss
        # the cube and deposit env every other iteration in both modes)
        done[key] = float(np.asarray(s["samples"])[6:10, 6:10].mean())
    assert done["majorant"] > done["exact"] * 3.0
