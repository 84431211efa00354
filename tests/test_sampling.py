import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vpt_jax import rng, sampling
from vpt_jax import volume as vol


def test_intersect_cube_through_center():
    origin = jnp.array([[0.5, 0.5, -1.0]])
    direction = jnp.array([[0.0, 0.0, 1.0]])
    tb = np.asarray(sampling.intersect_cube(origin, direction))
    assert np.allclose(tb, [[1.0, 2.0]])


def test_intersect_cube_miss():
    origin = jnp.array([[2.0, 2.0, -1.0]])
    direction = jnp.array([[0.0, 0.0, 1.0]])
    tb = np.asarray(sampling.intersect_cube(origin, direction))
    assert tb[0, 0] >= tb[0, 1]  # tnear >= tfar signals a miss


def test_intersect_cube_diagonal():
    origin = jnp.array([[-0.5, -0.5, -0.5]])
    direction = jnp.array([[1.0, 1.0, 1.0]])
    tb = np.asarray(sampling.intersect_cube(origin, direction))
    assert np.allclose(tb, [[0.5, 1.5]], atol=1e-6)


def test_unproject_identity():
    inv = jnp.eye(4, dtype=jnp.float32)
    f, t = sampling.unproject(jnp.array([[0.25, -0.5]]), inv)
    assert np.allclose(np.asarray(f), [[0.25, -0.5, -1.0]])
    assert np.allclose(np.asarray(t), [[0.25, -0.5, 1.0]])


def test_unproject_rand_zero_blur_matches_unproject_far_jitter_only():
    inv = jnp.eye(4, dtype=jnp.float32)
    ndc = jnp.array([[0.0, 0.0]])
    state = jnp.array([123], dtype=jnp.uint32)
    state, f, t = sampling.unproject_rand(state, ndc, inv,
                                          jnp.float32(1 / 64), jnp.float32(0))
    f0, t0 = sampling.unproject(ndc, inv)
    assert np.allclose(np.asarray(f), np.asarray(f0), atol=1e-6)
    # far point is jittered within one pixel
    assert np.all(np.abs(np.asarray(t)[:, :2] - np.asarray(t0)[:, :2]) <= 1 / 64)


def test_trilinear_at_texel_centers():
    data = np.arange(8, dtype=np.float32).reshape(2, 2, 2, 1)
    v = jnp.asarray(data)
    # texel centers: (0.25, 0.25, 0.25) -> corner value
    got = sampling.sample_volume(v, jnp.array([[0.25, 0.25, 0.25]]))
    assert np.allclose(np.asarray(got), [[0.0]])
    got = sampling.sample_volume(v, jnp.array([[0.75, 0.75, 0.75]]))
    assert np.allclose(np.asarray(got), [[7.0]])
    # center: average of all 8 texels
    got = sampling.sample_volume(v, jnp.array([[0.5, 0.5, 0.5]]))
    assert np.allclose(np.asarray(got), [[3.5]])


def test_trilinear_axis_order():
    # value = x index: shape (D=1, H=1, W=4)
    data = np.arange(4, dtype=np.float32).reshape(1, 1, 4, 1)
    v = jnp.asarray(data)
    got = sampling.sample_volume(v, jnp.array([[0.125, 0.5, 0.5],
                                               [0.875, 0.5, 0.5]]))
    assert np.allclose(np.asarray(got).ravel(), [0.0, 3.0])
    # y axis
    data_y = np.arange(4, dtype=np.float32).reshape(1, 4, 1, 1)
    got = sampling.sample_volume(jnp.asarray(data_y),
                                 jnp.array([[0.5, 0.125, 0.5]]))
    assert np.allclose(np.asarray(got).ravel(), [0.0])
    # z axis
    data_z = np.arange(4, dtype=np.float32).reshape(4, 1, 1, 1)
    got = sampling.sample_volume(jnp.asarray(data_z),
                                 jnp.array([[0.5, 0.5, 0.875]]))
    assert np.allclose(np.asarray(got).ravel(), [3.0])


def test_clamp_to_edge():
    data = np.arange(4, dtype=np.float32).reshape(1, 1, 4, 1)
    v = jnp.asarray(data)
    got = sampling.sample_volume(v, jnp.array([[-3.0, 0.5, 0.5],
                                               [4.0, 0.5, 0.5]]))
    assert np.allclose(np.asarray(got).ravel(), [0.0, 3.0])


def test_nearest_matches_rounding():
    data = np.arange(4, dtype=np.float32).reshape(1, 1, 4, 1)
    v = jnp.asarray(data)
    got = sampling.sample_volume_nearest(v, jnp.array([[0.3, 0.5, 0.5]]))
    assert np.allclose(np.asarray(got).ravel(), [1.0])


def test_cubic_matches_linear_at_centers():
    v = vol.sphere_volume(16).data
    p = jnp.array([[0.5, 0.5, 0.5], [0.53125, 0.5, 0.5]])
    lin = np.asarray(sampling.sample_volume(v, p))
    cub = np.asarray(sampling.sample_volume_cubic(v, p))
    assert np.allclose(lin[0], cub[0], atol=1e-6)  # texel center: identical


def test_sample_texture2d_bilinear():
    tex = np.zeros((2, 2, 4), np.float32)
    tex[0, 0] = [1, 0, 0, 1]
    tex[1, 1] = [0, 1, 0, 1]
    t = jnp.asarray(tex)
    got = np.asarray(sampling.sample_texture2d(t, jnp.array([[0.5, 0.5]])))
    assert np.allclose(got, [[0.25, 0.25, 0.0, 0.5]])


def test_volume_rg_single_channel_pads_zero():
    v = vol.sphere_volume(8).data
    rg = sampling.volume_rg(v, jnp.array([[0.5, 0.5, 0.5]]))
    assert rg.shape == (1, 2)
    assert float(rg[0, 1]) == 0.0


def test_sample_environment_directions():
    # env with distinct rows: top row (v=1) should be sampled for d.y = -1
    env = np.zeros((2, 4, 4), np.float32)
    env[0, :, 0] = 1.0  # bottom row red
    env[1, :, 1] = 1.0  # top row green
    e = jnp.asarray(env)
    down = sampling.sample_environment(e, jnp.array([[0.0, -1.0, 0.0]]))
    up = sampling.sample_environment(e, jnp.array([[0.0, 1.0, 0.0]]))
    assert np.asarray(down)[0, 1] == 1.0  # -y -> v=1 -> green row
    assert np.asarray(up)[0, 0] == 1.0    # +y -> v=0 -> red row


def test_hg_isotropic_unit_norm():
    state = jnp.arange(1000, dtype=jnp.uint32)
    direction = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (1000, 3))
    _, d = sampling.henyey_greenstein(state, 0.0, direction)
    assert np.allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-5)


def test_hg_anisotropy_biases_cosine():
    n = 200000
    state = jnp.arange(n, dtype=jnp.uint32)
    direction = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (n, 3))
    g = 0.7
    _, d = sampling.henyey_greenstein(state, g, direction)
    cos = np.asarray(d)[:, 2]
    # HG mean cosine = g
    assert abs(cos.mean() - g) < 0.01
    assert np.allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-4)


def test_value_gradient_matches_analytic():
    # linear field along x: alpha == x  (gray_ramp TF alpha = value)
    from vpt_jax import transfer
    n = 32
    x, _, _ = vol.normalized_grid(n, n, n)
    v = jnp.asarray(x[..., None].astype(np.float32))
    tf = transfer.gray_ramp()
    g = sampling.value_gradient(v, tf, jnp.array([[0.5, 0.5, 0.5]]),
                                jnp.float32(0.01))
    assert np.allclose(np.asarray(g), [[1.0, 0.0, 0.0]], atol=0.05)


def test_sample_volume_is_differentiable():
    v = vol.sphere_volume(8).data

    def loss(data):
        return jnp.sum(sampling.sample_volume(
            data, jnp.array([[0.4, 0.5, 0.6]])))

    g = jax.grad(loss)(v)
    assert g.shape == v.shape
    assert float(jnp.sum(g)) > 0.0  # interpolation weights sum to 1
    assert np.isclose(float(jnp.sum(g)), 1.0, atol=1e-5)


def test_packed_volume_matches_slow_path():
    v = vol.blobs_volume(16, seed=2).data
    packed = sampling.pack_corner_volume(v)
    rng_np = np.random.default_rng(0)
    # positions spanning inside, edges, and out-of-range
    p = jnp.asarray(rng_np.uniform(-0.3, 1.3, (5000, 3)).astype(np.float32))
    slow = np.asarray(sampling.sample_volume(v, p))
    fast = np.asarray(sampling.sample_volume_packed(packed, v.shape, p))
    assert np.allclose(slow, fast, atol=1e-6)


def test_folded_packed_volume_matches_slow_path():
    """Folded corner tables (wide rows below the backward scatter cliff —
    sampling.py's fold note) must stay bit-identical to the unfolded packed
    sampler and gradient-exact vs the unpacked oracle."""
    v = vol.blobs_volume(16, seed=2).data
    rng_np = np.random.default_rng(0)
    p = jnp.asarray(rng_np.uniform(-0.3, 1.3, (5000, 3)).astype(np.float32))
    base = np.asarray(sampling.sample_volume_packed(
        sampling.pack_corner_volume(v), v.shape, p))
    co = jnp.asarray(rng_np.normal(size=(5000, 1)).astype(np.float32))
    g_ref = jax.grad(lambda d: jnp.sum(sampling.sample_volume(d, p) * co))(v)
    for fold in (1, 2, 4):
        folded = sampling.pack_corner_volume(v, fold)
        assert folded.shape == (16 ** 3 >> fold, 8 << fold)
        fast = np.asarray(sampling.sample_volume_packed(folded, v.shape, p))
        assert np.array_equal(base, fast)
        g = jax.grad(lambda d: jnp.sum(sampling.sample_volume_packed(
            sampling.pack_corner_volume(d, fold), d.shape, p) * co))(v)
        assert np.allclose(np.asarray(g), np.asarray(g_ref), atol=1e-5)


def test_scatter_fold_log2_policy():
    # below the cliff: no fold; above: fold to <=2^18 rows, lanes <=128
    assert sampling.scatter_fold_log2(64 ** 3, 8, 64) == 0
    assert sampling.scatter_fold_log2(128 ** 3, 8, 128) == 3
    assert sampling.scatter_fold_log2(256 ** 3, 8, 256) == 4   # lane cap
    assert sampling.scatter_fold_log2(256 ** 3, 32, 256) == 2  # C=4 volumes
    # fold must divide the x extent
    assert sampling.scatter_fold_log2(150 ** 3, 8, 150) == 1


def test_packed_texture_matches_slow_path():
    from vpt_jax import transfer
    t = transfer.rasterize(transfer.TransferFunctionBumps.default(), 32, 32)
    packed = sampling.pack_corner_texture2d(t)
    rng_np = np.random.default_rng(1)
    uv = jnp.asarray(rng_np.uniform(-0.2, 1.2, (3000, 2)).astype(np.float32))
    slow = np.asarray(sampling.sample_texture2d(t, uv))
    fast = np.asarray(sampling.sample_texture2d_packed(packed, t.shape, uv))
    assert np.allclose(slow, fast, atol=1e-6)


def test_mxu_transfer_matches_bilinear_lookup():
    """The one-hot-matmul 1D TF path must match the 2D bilinear lookup at
    uv=(value, 0).  f32 table: near-exact; bf16 table: ~8-bit fraction
    precision (the opt-in fast-path contract)."""
    from vpt_jax import transfer
    t = transfer.rasterize(transfer.TransferFunctionBumps.default(), 64, 64)
    rng_np = np.random.default_rng(3)
    value = jnp.asarray(rng_np.uniform(-0.1, 1.1, (4000,)).astype(np.float32))
    uv = jnp.stack([value, jnp.zeros_like(value)], axis=-1)
    oracle = np.asarray(sampling.sample_texture2d(t, uv))

    tab32 = sampling.pack_mxu_transfer(t, jnp.float32)
    got32 = np.asarray(sampling.sample_transfer_1d_mxu(tab32, value))
    assert np.allclose(oracle, got32, atol=1e-5)

    tab16 = sampling.pack_mxu_transfer(t, jnp.bfloat16)
    got16 = np.asarray(sampling.sample_transfer_1d_mxu(tab16, value))
    assert np.allclose(oracle, got16, atol=2e-2)


def test_mxu_transfer_chunked_path_matches(monkeypatch):
    """Batches above _MXU_CHUNK_ROWS loop the matmul over row chunks
    (HBM-pressure cap for the 8·H·W march batches); the loop must be
    value-identical to the single matmul."""
    from vpt_jax import transfer
    t = transfer.rasterize(transfer.TransferFunctionBumps.default(), 64, 64)
    tab = sampling.pack_mxu_transfer(t, jnp.float32)
    rng_np = np.random.default_rng(7)
    value = jnp.asarray(rng_np.uniform(0, 1, (3, 701)).astype(np.float32))
    whole = np.asarray(sampling.sample_transfer_1d_mxu(tab, value))
    monkeypatch.setattr(sampling, "_MXU_CHUNK_ROWS", 256)
    chunked = np.asarray(sampling.sample_transfer_1d_mxu(tab, value))
    assert chunked.shape == value.shape + (4,)
    assert np.array_equal(whole, chunked)


def test_scene_tf_mxu_renders_close_to_gather_path():
    """An mcm frame on a tf_mxu scene stays close to the gather-path frame
    (identical RNG stream; only the TF lookup numerics differ)."""
    from vpt_jax import transfer
    from vpt_jax.renderers import make_scene, mcm
    v = vol.sphere_volume(16)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    sc_mxu = make_scene(v, tf, tf_mxu=True)
    assert sc_mxu.transfer_mxu is not None
    sc_ref = make_scene(v, tf)
    params = mcm.Params(extinction=30.0, steps=4)
    s0a = mcm.reset(params, 16, 16, sc_mxu)
    s0b = mcm.reset(params, 16, 16, sc_ref)
    a = mcm.render_frame(s0a, sc_mxu, params, jnp.float32(0.4), jnp.int32(1))
    b = mcm.render_frame(s0b, sc_ref, params, jnp.float32(0.4), jnp.int32(1))
    assert np.allclose(np.asarray(a["radiance"]), np.asarray(b["radiance"]),
                       atol=1e-4)


def test_scene_fast_path_matches_unpacked_render():
    """A packed scene must render the same as an unpacked one: discrete
    outcomes (samples, bounces) exactly, float state to float32 rounding
    (XLA fuses the two lerp pipelines differently — fma vs mul+add — so
    1-ulp differences are expected)."""
    from vpt_jax import transfer
    from vpt_jax.renderers import make_scene, mcm
    v = vol.sphere_volume(16)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    sc_fast = make_scene(v, tf, pack=True)
    sc_slow = make_scene(v, tf, pack=False)
    params = mcm.Params(extinction=30.0, steps=8)
    s0f = mcm.reset(params, 16, 16, sc_fast)
    s0s = mcm.reset(params, 16, 16, sc_slow)
    f = mcm.render_frame(s0f, sc_fast, params, jnp.float32(0.4), jnp.int32(1))
    s = mcm.render_frame(s0s, sc_slow, params, jnp.float32(0.4), jnp.int32(1))
    for k in ("samples", "bounces"):
        assert np.array_equal(np.asarray(f[k]), np.asarray(s[k])), k
    for k in ("position", "direction", "transmittance", "radiance"):
        assert np.allclose(np.asarray(f[k]), np.asarray(s[k]),
                           atol=1e-6), k


def test_make_scene_tf_srgb_applies_gl_semantics():
    from vpt_jax import transfer as tf_mod
    from vpt_jax.renderers import make_scene
    v = vol.sphere_volume(8)
    tf = tf_mod.gray_ramp(alpha_scale=1.0)
    sc = make_scene(v, tf, tf_srgb=True, pack=False)
    expect = np.asarray(tf_mod.to_gl_texture(tf, srgb=True, quantize=True))
    assert np.allclose(np.asarray(sc.transfer), expect)
    # alpha stays linear (only quantized); colors are decoded (smaller)
    assert np.all(np.asarray(sc.transfer[..., :3])
                  <= np.asarray(sc.transfer[..., 3:4]) + 1e-6)


@pytest.mark.parametrize("width", [256, 200], ids=["w256", "w200"])
def test_mxu_transfer_f32_matches_bilinear_at_y0(width):
    """A float32 one-hot table reproduces the bilinear y = 0 lookup (GL
    clamp included) for a TF width that is a multiple of 128 and one that
    is not."""
    t = jnp.asarray(np.random.default_rng(width)
                    .uniform(0, 1, (2, width, 4)).astype(np.float32))
    value = jnp.asarray(np.random.default_rng(1)
                        .uniform(-0.1, 1.1, (16, 128)).astype(np.float32))
    uv = jnp.stack([value, jnp.zeros_like(value)], axis=-1)
    oracle = np.asarray(sampling.sample_texture2d(t, uv))
    got = np.asarray(sampling.sample_transfer_1d_mxu(
        sampling.pack_mxu_transfer(t, jnp.float32), value))
    assert got.shape == (16, 128, 4)
    assert np.allclose(got, oracle, atol=1e-6)


def test_mxu_transfer_in_march_chunks_matches_gather():
    """The marchers sample chunk-of-slices batches (4-D positions in
    renderers/_march.py); a float32 one-hot TF there renders the same
    EAM frame as the bilinear gather."""
    from vpt_jax import transfer
    from vpt_jax.renderers import eam, make_scene
    v = vol.sphere_volume(16)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    sc_mxu = make_scene(v, tf, tf_mxu=True)
    assert sc_mxu.transfer_mxu.dtype == jnp.float32
    sc_ref = make_scene(v, tf)
    params = eam.Params(slices=16, random=False)
    a = eam.generate(sc_mxu, params, jnp.float32(0.0), 16, 16)
    b = eam.generate(sc_ref, params, jnp.float32(0.0), 16, 16)
    assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-6)
