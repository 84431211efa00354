"""Estimator-level gradient tests for the differentiable MC renderers:
mean gradients over many samples vs analytic / finite-difference oracles
(SURVEY.md §4.3, BASELINE configs 2-4)."""

import numpy as np
import jax
import jax.numpy as jnp

from vpt_jax import sampling, volume
from vpt_jax.renderers import diff_mc, make_scene, mcm, mcs


def _absorbing_scene(alpha):
    """Homogeneous unit-density volume; TF rgb=0, alpha=`alpha` -> purely
    absorbing medium with true extinction alpha * extinction."""
    vol = volume.Volume(jnp.ones((4, 4, 4, 1), jnp.float32))
    tf = jnp.zeros((2, 2, 4), jnp.float32).at[..., 3].set(alpha)
    return make_scene(vol, tf, pack=False)


def _path_lengths(scene, n):
    ndc = sampling.pixel_ndc(n, n)
    f, t = sampling.unproject(ndc, scene.mvp_inverse)
    tb = jnp.maximum(sampling.intersect_cube(f, t - f), 0.0)
    seg = (tb[..., 1] - tb[..., 0])[..., None] * (t - f)
    return jnp.sqrt(jnp.sum(seg ** 2, axis=-1))


def test_mcm_mean_matches_analytic_transmittance():
    n = 5
    sigma_bar = 4.0
    params = mcm.Params(extinction=sigma_bar, blur=0.0, steps=32)

    def estimate(theta):
        sc = _absorbing_scene(theta)
        img = diff_mc.mcm_expected_image(sc, params, n, n, frames=300)
        return img

    theta = jnp.float32(0.4)
    img = np.asarray(estimate(theta))
    L = np.asarray(_path_lengths(_absorbing_scene(theta), n))
    analytic = np.exp(-sigma_bar * 0.4 * L)
    # resetPhoton antialiases rays within ±1 pixel, which at 5×5 resolution
    # mixes silhouette misses into border pixels — compare the center pixel,
    # whose jittered rays all traverse the deep interior
    c = n // 2
    assert abs(img[c, c, 0] - analytic[c, c]) < 0.05, (
        img[c, c, 0], analytic[c, c])


def test_mcm_gradient_matches_analytic():
    """d/dθ E[image] for a homogeneous absorber: -σ̄ L exp(-σ̄ θ L)."""
    n = 5
    sigma_bar = 4.0
    params = mcm.Params(extinction=sigma_bar, steps=32)

    def mean_radiance(theta):
        sc = _absorbing_scene(theta)
        img = diff_mc.mcm_expected_image(sc, params, n, n, frames=400)
        c = n // 2
        return img[c, c, 0]

    theta = jnp.float32(0.4)
    g = float(jax.grad(mean_radiance)(theta))
    L = np.asarray(_path_lengths(_absorbing_scene(theta), n))
    c = n // 2
    analytic = float(-sigma_bar * L[c, c]
                     * np.exp(-sigma_bar * 0.4 * L[c, c]))
    assert np.isfinite(g)
    # score-function estimator: statistical tolerance ~15%
    assert abs(g - analytic) < 0.15 * abs(analytic) + 0.02, (g, analytic)


def test_mcm_scatter_gradient_flows_to_color():
    """With nonzero rgb the pathwise tint gradient must flow."""
    vol = volume.Volume(jnp.ones((4, 4, 4, 1), jnp.float32))

    def mean_radiance(c):
        tf = jnp.zeros((2, 2, 4), jnp.float32)
        tf = tf.at[..., 0].set(c).at[..., 1].set(c).at[..., 2].set(c)
        tf = tf.at[..., 3].set(0.5)
        sc = make_scene(vol, tf, pack=False)
        params = mcm.Params(extinction=3.0, steps=16)
        img = diff_mc.mcm_expected_image(sc, params, 4, 4, frames=100)
        return jnp.mean(img[..., :3])

    g = float(jax.grad(mean_radiance)(jnp.float32(0.6)))
    # brighter scatter tint -> more radiance
    assert np.isfinite(g) and g > 0.0


def test_mcs_gradient_vs_finite_difference():
    """MCS estimator mean-gradient vs FD of the mean (independent seeds)."""
    n = 6
    params = mcs.Params(extinction=3.0)

    def mean_image(theta, seed0):
        vol = volume.Volume(jnp.ones((4, 4, 4, 1), jnp.float32))
        tf = jnp.zeros((2, 2, 4), jnp.float32)
        tf = tf.at[..., :3].set(0.8).at[..., 3].set(theta)
        sc = make_scene(vol, tf, pack=False)
        img = diff_mc.mcs_expected_image(sc, params, n, n, frames=250,
                                         seed0=seed0)
        return jnp.mean(img[..., :3])

    theta = jnp.float32(0.35)
    g = float(jax.grad(lambda t: mean_image(t, 0.1))(theta))
    eps = 5e-2
    fd = (float(mean_image(theta + eps, 0.1))
          - float(mean_image(theta - eps, 0.1))) / (2 * eps)
    assert np.isfinite(g)
    assert abs(g - fd) < 0.25 * abs(fd) + 0.03, (g, fd)


def test_diff_mcm_value_matches_analog():
    """The ratio weights are exactly 1 in value: the differentiable frame
    must reproduce the analog renderer's radiance bit-for-bit-ish."""
    sc = make_scene(volume.sphere_volume(8),
                    jnp.zeros((2, 2, 4), jnp.float32).at[..., 3].set(0.5)
                    .at[..., :3].set(0.7), pack=False)
    params = mcm.Params(extinction=10.0, steps=16)
    s_analog = mcm.reset(params, 8, 8, sc, seed=0.2)
    s_diff = diff_mc.mcm_reset(params, 8, 8, sc, seed=0.2)
    out_a = mcm.render_frame(s_analog, sc, params, jnp.float32(0.6),
                             jnp.int32(1))
    out_d = diff_mc.mcm_render_frame(s_diff, sc, params, jnp.float32(0.6),
                                     jnp.int32(1))
    assert np.allclose(np.asarray(out_a["radiance"]),
                       np.asarray(out_d["radiance"]), atol=1e-5)
    assert np.array_equal(np.asarray(out_a["samples"]),
                          np.asarray(out_d["samples"]))


def test_diff_mcs_value_matches_analog():
    """MCS ratio weights are 1 in value: the differentiable generate must
    reproduce the analog frame (identical RNG streams)."""
    sc = make_scene(volume.sphere_volume(8),
                    jnp.zeros((2, 2, 4), jnp.float32)
                    .at[..., 3].set(0.5).at[..., :3].set(0.7), pack=False)
    params = mcs.Params(extinction=5.0)
    from vpt_jax.renderers.mcs import generate as analog_generate
    a = analog_generate(sc, params, jnp.float32(0.3), 8, 8)
    d = diff_mc.mcs_generate(sc, params, jnp.float32(0.3), 8, 8)
    assert np.allclose(np.asarray(a), np.asarray(d), atol=1e-5)


def test_packed_in_graph_gradients_match_unpacked():
    """fit_mc's fast path corner-packs the volume inside the differentiated
    graph (benchmarks/backward.py); forward values must be bit-identical
    and gradients allclose to the unpacked oracle."""
    import dataclasses

    vol = volume.sphere_volume(8)
    from vpt_jax import transfer
    tf = transfer.gray_ramp(alpha_scale=0.8)
    template = make_scene(vol, tf, pack=False)
    params = mcm.Params(extinction=10.0, steps=8)

    def loss(voxels, packed):
        sc = dataclasses.replace(
            template, volume=voxels,
            volume_packed=(sampling.pack_corner_volume(voxels)
                           if packed else None),
            transfer_packed=(sampling.pack_corner_texture2d(
                template.transfer) if packed else None))
        img = diff_mc.mcm_expected_image(sc, params, 6, 6, frames=3)
        return jnp.mean(img ** 2)

    voxels = template.volume
    v_u, g_u = jax.value_and_grad(lambda v: loss(v, False))(voxels)
    v_p, g_p = jax.value_and_grad(lambda v: loss(v, True))(voxels)
    assert float(v_u) == float(v_p)          # forward bit-identical
    assert np.allclose(np.asarray(g_u), np.asarray(g_p), atol=1e-6)


def test_folded_in_graph_gradients_match_unpacked():
    """The folded corner table (fit_mc's layout for big volumes — wide rows
    below the backward scatter cliff, sampling.py's fold note) must keep
    the end-to-end MCM estimator bit-identical forward and gradient-equal
    to the unpacked oracle."""
    import dataclasses

    vol = volume.sphere_volume(8)
    from vpt_jax import transfer
    tf = transfer.gray_ramp(alpha_scale=0.8)
    template = make_scene(vol, tf, pack=False)
    params = mcm.Params(extinction=10.0, steps=8)

    def loss(voxels, fold):
        sc = dataclasses.replace(
            template, volume=voxels,
            volume_packed=(sampling.pack_corner_volume(voxels, fold)
                           if fold is not None else None),
            transfer_packed=(sampling.pack_corner_texture2d(
                template.transfer) if fold is not None else None))
        img = diff_mc.mcm_expected_image(sc, params, 6, 6, frames=3)
        return jnp.mean(img ** 2)

    voxels = template.volume
    v_u, g_u = jax.value_and_grad(lambda v: loss(v, None))(voxels)
    for fold in (1, 3):
        v_f, g_f = jax.value_and_grad(lambda v: loss(v, fold))(voxels)
        assert float(v_u) == float(v_f)      # forward bit-identical
        assert np.allclose(np.asarray(g_u), np.asarray(g_f), atol=1e-6)
