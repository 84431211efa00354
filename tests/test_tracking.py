"""Cheb-skip empty-space tracking (skipgrid.pack_tracking_volume) — the
voxel-resolution empty-space acceleration that rides the event loop's
existing corner gather.

Contract under test:
- empty cells (TF alpha exactly 0 over the cell's whole trilinear value
  range) carry -chebdist in every packed lane; occupied cells carry their
  true corner values,
- the Chebyshev distance field is exact (brute-force oracle),
- skip hops of (cheb-1) cells never land where alpha > 0 (the
  memorylessness argument's precondition),
- with NO empty cells the tracking machine is bit-identical to the exact
  global-majorant machine (same draws, same branches, same floats),
- on sparse scenes it converges to the exact machine's image and
  completes paths faster,
- the make_scene(tracking=...) policy engages exactly when it should.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vpt_jax import sampling, skipgrid, transfer, volume
from vpt_jax.renderers import make_renderer, make_scene, mcm


def _sparse_ball(n=32, r=0.15, value=0.9):
    g = (np.arange(n) + 0.5) / n - 0.5
    r2 = (g[:, None, None] ** 2 + g[None, :, None] ** 2
          + g[None, None, :] ** 2)
    return jnp.asarray(np.where(r2 < r * r, value, 0.0)
                       .astype(np.float32)[..., None])


def _zero_floor_tf(alpha_scale=0.5, floor_texels=8):
    """gray_ramp with an exactly-zero alpha floor.  The plain ramp's texel 0
    carries alpha = scale·0.5/TW > 0, so nothing is ever TF-empty; real
    reference TFs (Gaussian bumps on a transparent canvas, or any TF through
    the SRGB8_ALPHA8 texture quantization) have large exact-zero regions."""
    tf = np.asarray(transfer.gray_ramp(alpha_scale=alpha_scale)).copy()
    tf[:, :floor_texels, 3] = 0.0
    return jnp.asarray(tf)


def _brute_cheb(occ, cap):
    """O(N^6) Chebyshev distance oracle (tiny volumes only)."""
    pts = np.argwhere(occ)
    d = np.full(occ.shape, float(cap), np.float32)
    for idx in np.ndindex(occ.shape):
        if occ[idx]:
            d[idx] = 0.0
        elif len(pts):
            d[idx] = min(cap, np.abs(pts - np.array(idx)).max(1).min())
    return d


def test_tracking_table_contents():
    vol = _sparse_ball(12, r=0.2)
    tf = _zero_floor_tf(alpha_scale=0.5)
    rows = np.asarray(skipgrid.pack_tracking_volume(vol, tf, cap=8))
    packed = np.asarray(sampling.pack_corner_volume(vol))
    empty = np.asarray(skipgrid.cell_empty_mask(jnp.asarray(packed), tf))
    assert empty.any() and (~empty).any()
    # occupied rows: untouched corner values
    assert np.array_equal(rows[~empty], packed[~empty])
    # empty rows: constant -cheb in all 8 lanes
    assert (rows[empty] < 0).all()
    assert (rows[empty] == rows[empty][:, :1]).all()
    # cheb field matches the brute-force oracle
    cheb = _brute_cheb((~empty).reshape(12, 12, 12), cap=8)
    assert np.array_equal(-rows[empty][:, 0], cheb.reshape(-1)[empty])


def test_chebyshev_distance_exact():
    rng = np.random.default_rng(3)
    occ = rng.random((9, 9, 9)) < 0.04
    occ[0, 0, 0] = True                      # ensure non-empty
    got = np.asarray(skipgrid.chebyshev_distance(jnp.asarray(occ), cap=6))
    assert np.array_equal(got, _brute_cheb(occ, cap=6))


def test_tracking_gating_and_policy():
    tf = _zero_floor_tf(alpha_scale=0.5)
    # multi-channel volumes unsupported
    assert skipgrid.pack_tracking_volume(
        jnp.ones((8, 8, 8, 2), jnp.float32), tf) is None
    # negative values would collide with the -cheb encoding
    assert skipgrid.pack_tracking_volume(
        -jnp.ones((8, 8, 8, 1), jnp.float32), tf) is None
    # policy: sparse scene engages, TF-dense scene does not
    sparse = make_scene(_sparse_ball(16), tf, tracking="auto")
    assert sparse.tracking_packed is not None
    opaque_tf = np.zeros((2, 256, 4), np.float32)
    opaque_tf[..., 3] = 0.3
    dense = make_scene(volume.sphere_volume(16), jnp.asarray(opaque_tf),
                       tracking="auto")
    assert dense.tracking_packed is None
    # explicit "cheb" builds even for dense scenes; "none" never does
    assert make_scene(volume.sphere_volume(16), jnp.asarray(opaque_tf),
                      tracking="cheb").tracking_packed is not None
    assert make_scene(_sparse_ball(16), tf).tracking_packed is None
    with pytest.raises(ValueError):
        make_scene(_sparse_ball(16), tf, tracking="warp")
    # "grid" routes to the majorant grid, not cheb-skip
    g = make_scene(_sparse_ball(16), tf, tracking="grid")
    assert g.majorant is not None and g.tracking_packed is None


def test_skip_hop_lands_in_empty_space():
    """From any position in an empty cell, a hop of (cheb-1) cells in any
    direction lands where TF alpha == 0 (the skip's validity invariant)."""
    vol = _sparse_ball(24, r=0.22)
    tf = _zero_floor_tf(alpha_scale=0.5)
    sc = make_scene(vol, tf, tracking="cheb")
    rng = np.random.default_rng(11)
    pos = jnp.asarray(rng.uniform(0, 1, (8192, 3)).astype(np.float32))
    dirs = rng.normal(size=(8192, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    _, cheb = sc.sample_color_tracking(pos)
    hop = np.maximum(np.asarray(cheb) - 1.0, 0.0) / 24.0
    landing = pos + jnp.asarray(hop[:, None]) * jnp.asarray(dirs)
    vs_land, _ = sc.sample_color_tracking(landing)
    inside = np.asarray(jnp.all((landing >= 0) & (landing <= 1), axis=-1))
    alpha = np.asarray(vs_land[..., 3])
    assert not np.any((alpha > 0) & inside & (np.asarray(cheb) >= 1))


def test_no_empty_cells_bit_identical_to_exact():
    """With a TF that is nowhere exactly zero there are no empty cells, so
    the tracking machine must reproduce the exact machine bit for bit
    (hop == 0 always, same sampler values, same RNG stream)."""
    tf = np.zeros((2, 256, 4), np.float32)
    tf[..., :3] = 0.8
    tf[..., 3] = np.linspace(0.05, 0.6, 256, dtype=np.float32)
    vol = volume.sphere_volume(16)
    params = mcm.Params(extinction=25.0, anisotropy=0.3, steps=16)
    out = {}
    for key, mode in (("exact", "none"), ("skip", "cheb")):
        sc = make_scene(vol, jnp.asarray(tf), tracking=mode)
        s = mcm.reset(params, 24, 24, sc)
        for i in range(4):
            s = mcm.render_frame(s, sc, params, jnp.float32(0.3 + i),
                                 jnp.int32(i + 1))
        out[key] = s
    assert np.array_equal(np.asarray(out["exact"]["radiance"]),
                          np.asarray(out["skip"]["radiance"]))
    assert np.array_equal(np.asarray(out["exact"]["samples"]),
                          np.asarray(out["skip"]["samples"]))


def test_tracking_converges_to_exact_image():
    n = 12
    params = mcm.Params(extinction=30.0, anisotropy=0.0, steps=16)
    vol = volume.sphere_volume(32)
    tf = _zero_floor_tf(alpha_scale=1.0)
    imgs = {}
    for key, mode in (("exact", "none"), ("skip", "cheb")):
        sc = make_scene(vol, tf, tracking=mode)
        r = make_renderer("mcm", params=params, height=n, width=n)
        imgs[key] = np.asarray(r.render_progressive(sc, frames=150,
                                                    seed0=3))
    assert np.abs(imgs["exact"] - imgs["skip"]).max() < 0.12
    assert np.abs(imgs["exact"].mean() - imgs["skip"].mean()) < 0.02


def test_tracking_makes_progress_faster():
    """Sparse scene: cheb-skip completes several times more through-volume
    paths per event budget than the exact machine."""
    vol = _sparse_ball(32, r=0.15)
    tf = _zero_floor_tf(alpha_scale=0.5)
    params = mcm.Params(extinction=60.0, steps=32)
    done = {}
    for key, mode in (("exact", "none"), ("skip", "cheb")):
        sc = make_scene(vol, tf, tracking=mode)
        s = mcm.reset(params, 16, 16, sc)
        for i in range(3):
            s = mcm.render_frame(s, sc, params, jnp.float32(0.5 + i),
                                 jnp.int32(i + 1))
        done[key] = float(np.asarray(s["samples"])[6:10, 6:10].mean())
    assert done["skip"] > done["exact"] * 3.0


def test_gather_packed_corners_validates_fold():
    """ADVICE r2: mismatched table/shape pairs must raise, not silently
    gather wrong corners."""
    packed = sampling.pack_corner_volume(jnp.ones((4, 4, 4, 1)))
    idx = jnp.zeros((5,), jnp.int32)
    with pytest.raises(ValueError):
        sampling.gather_packed_corners(packed, idx, 3 * 64, 1)  # ratio 3
    with pytest.raises(ValueError):
        sampling.gather_packed_corners(packed, idx, 65, 1)  # non-divisible
    out = sampling.gather_packed_corners(packed, idx, 64, 1)
    assert out.shape == (5, 8, 1)


def test_mcs_no_empty_cells_matches_exact():
    """MCS with a tracking table but no empty cells runs the same draws
    and branches (hop == 0 always; the samplers are bitwise equal —
    asserted below), but the extra loop carry changes XLA's fusion
    context, which reassociates float products by ~1 ulp (the same
    compile-context effect documented for shard_map in halo.py) — so the
    frame comparison is at 1-ulp tolerance rather than bitwise."""
    from vpt_jax.renderers import mcs

    tf = np.zeros((2, 256, 4), np.float32)
    tf[..., :3] = 0.7
    tf[..., 3] = np.linspace(0.05, 0.5, 256, dtype=np.float32)
    vol = volume.sphere_volume(16)
    params = mcs.Params(extinction=25.0)
    out = {}
    for key, mode in (("exact", "none"), ("skip", "cheb")):
        sc = make_scene(vol, jnp.asarray(tf), tracking=mode)
        if mode == "cheb":
            rng = np.random.default_rng(0)
            pos = jnp.asarray(rng.uniform(0, 1, (512, 3)).astype(np.float32))
            vs, cheb = sc.sample_color_tracking(pos)
            assert np.array_equal(np.asarray(vs),
                                  np.asarray(sc.sample_color(pos)))
            assert float(jnp.max(cheb)) == 0.0
        out[key] = np.asarray(mcs.generate(sc, params, jnp.float32(0.4),
                                           24, 24))
    np.testing.assert_allclose(out["exact"], out["skip"], rtol=0, atol=1e-5)


def test_mcs_tracking_converges_to_exact_image():
    from vpt_jax.renderers import mcs

    n = 12
    params = mcs.Params(extinction=40.0)
    vol = volume.sphere_volume(32)
    tf = _zero_floor_tf(alpha_scale=1.0)
    imgs = {}
    for key, mode in (("exact", "none"), ("skip", "cheb")):
        sc = make_scene(vol, tf, tracking=mode)
        r = make_renderer("mcs", params=params, height=n, width=n)
        imgs[key] = np.asarray(r.render_progressive(sc, frames=200,
                                                    seed0=3))
    assert np.abs(imgs["exact"] - imgs["skip"]).max() < 0.15
    assert np.abs(imgs["exact"].mean() - imgs["skip"].mean()) < 0.02


def test_resumed_tracking_state_runs_on_plain_scene():
    """A photon state carrying the cheb slot (saved from a tracking render)
    must keep rendering when resumed against a scene WITHOUT a tracking
    table (checkpoint + --tracking none, or the auto policy flipping after
    a TF edit) — the stale carry threads through unchanged."""
    vol = volume.sphere_volume(16)
    tf_track = _zero_floor_tf()
    sc_track = make_scene(vol, tf_track, tracking="cheb")
    sc_plain = make_scene(vol, tf_track, tracking="none")
    params = mcm.Params(extinction=20.0, steps=4)
    state = mcm.reset(params, 8, 8, sc_track)
    assert "cheb" in state
    state = mcm.render_frame(state, sc_track, params, jnp.float32(0.2),
                             jnp.int32(1))
    out = mcm.render_frame(state, sc_plain, params, jnp.float32(0.3),
                           jnp.int32(2))
    assert "cheb" in out
    assert np.isfinite(np.asarray(out["radiance"])).all()


def test_explicit_tracking_requests_do_not_silently_degrade():
    tf = _zero_floor_tf()
    # conflicting explicit machines: error
    with pytest.raises(ValueError):
        make_scene(_sparse_ball(16), tf, tracking="cheb", majorant_grid=8)
    # unsupported explicit cheb (multi-channel volume): warn + fall back
    vol2 = volume.with_gradient_magnitude(volume.sphere_volume(16))
    with pytest.warns(UserWarning, match="tracking='cheb'"):
        sc = make_scene(vol2, tf, tracking="cheb")
    assert sc.tracking_packed is None
    # unsupported explicit grid (12^3 not divisible by the 16^3 default):
    # warn + fall back
    with pytest.warns(UserWarning, match="tracking='grid'"):
        sc = make_scene(_sparse_ball(12), tf, tracking="grid")
    assert sc.majorant is None and sc.tracking_packed is None


def test_tracking_respects_volume_filter():
    """Tracking tables implement the linear filter only: nearest-filter
    volumes must not silently render through trilinear skip tables."""
    from vpt_jax.volume import Volume

    tf = _zero_floor_tf()
    vol = Volume(_sparse_ball(16), "nearest")
    sc = make_scene(vol, tf, tracking="auto")
    assert sc.tracking_packed is None          # auto declines silently
    with pytest.warns(UserWarning, match="linear filter"):
        sc = make_scene(vol, tf, tracking="cheb")
    assert sc.tracking_packed is None


def test_auto_policy_declines_before_distance_transform(monkeypatch):
    """The auto policy's empty-fraction decline must happen BEFORE the
    cap-iteration Chebyshev transform (scene rebuilds on dense volumes
    would otherwise pay it for nothing)."""
    called = []
    real = skipgrid.chebyshev_distance

    def spy(occ, cap=skipgrid.CHEB_CAP):
        called.append(True)
        return real(occ, cap)

    monkeypatch.setattr(skipgrid, "chebyshev_distance", spy)
    opaque_tf = np.zeros((2, 256, 4), np.float32)
    opaque_tf[..., 3] = 0.3
    sc = make_scene(volume.sphere_volume(16), jnp.asarray(opaque_tf),
                    tracking="auto")
    assert sc.tracking_packed is None
    assert not called                          # declined without the DT
    sc = make_scene(_sparse_ball(16), _zero_floor_tf(), tracking="auto")
    assert sc.tracking_packed is not None and called
