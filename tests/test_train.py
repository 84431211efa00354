"""Gradient correctness (finite-difference oracles) and inverse rendering."""

import numpy as np
import jax
import jax.numpy as jnp

from vpt_jax import transfer, volume
from vpt_jax.renderers import eam
from vpt_jax.scene import CameraState, default_camera
from vpt_jax.train import fit, render_eam


def _mats():
    cam = CameraState.from_nodes(default_camera())
    return (cam.mvp_inverse, cam.model_view, cam.projection)


def test_eam_voxel_gradients_match_finite_difference():
    """allclose(1e-4) vs central finite differences on voxel densities
    (BASELINE.md gradient-correctness criterion)."""
    mats = _mats()
    tf = transfer.gray_ramp(alpha_scale=1.0)
    params = eam.Params(slices=16, random=False, extinction=50.0)
    n = 8
    rng = np.random.default_rng(0)
    vol = jnp.asarray(rng.uniform(0.1, 0.6, (n, n, n, 1)).astype(np.float32))

    def loss(v):
        img = render_eam(v, tf, mats, params, jnp.float32(0.0), 16, 16)
        return jnp.mean(img[..., :3])

    g = np.asarray(jax.grad(loss)(vol))

    # probe a handful of voxels with central differences (float64 off, so
    # use a moderately large eps and a loose-but-meaningful tolerance)
    eps = 1e-2
    probes = [(4, 4, 4, 0), (2, 5, 3, 0), (6, 2, 4, 0), (3, 3, 6, 0)]
    for idx in probes:
        vp = vol.at[idx].add(eps)
        vm = vol.at[idx].add(-eps)
        fd = (float(loss(vp)) - float(loss(vm))) / (2 * eps)
        assert abs(fd - g[idx]) < 1e-4 + 0.05 * abs(fd), (idx, fd, g[idx])


def test_eam_tf_gradients_match_finite_difference():
    mats = _mats()
    params = eam.Params(slices=16, random=False, extinction=50.0)
    vol = volume.sphere_volume(8).data
    tf = transfer.gray_ramp(alpha_scale=0.8)

    def loss(t):
        img = render_eam(vol, t, mats, params, jnp.float32(0.0), 16, 16)
        return jnp.mean(img[..., :3])

    g = np.asarray(jax.grad(loss)(tf))
    eps = 1e-2
    for idx in [(0, 128, 3), (1, 64, 0), (0, 200, 3)]:
        tp = tf.at[idx].add(eps)
        tm = tf.at[idx].add(-eps)
        fd = (float(loss(tp)) - float(loss(tm))) / (2 * eps)
        assert abs(fd - g[idx]) < 1e-4 + 0.05 * abs(fd), (idx, fd, g[idx])


def test_tf_bump_gradients_flow():
    """Gradients reach the Gaussian-bump parameters through rasterize."""
    bumps = transfer.TransferFunctionBumps.default()

    def loss(b):
        return jnp.sum(transfer.rasterize(b, 32, 32))

    g = jax.grad(loss)(bumps)
    assert np.isfinite(np.asarray(g.positions)).all()
    assert float(jnp.abs(g.colors).sum()) > 0.0


def test_fit_recovers_volume_loss_decreases():
    """Inverse rendering drives the loss down by >10x on a small problem."""
    mats = _mats()
    tf = transfer.gray_ramp(alpha_scale=1.0)
    params = eam.Params(slices=16, random=False)
    target_vol = volume.sphere_volume(8)
    target = render_eam(target_vol.data, tf, mats, params, jnp.float32(0.0),
                        24, 24)

    init = jnp.full((8, 8, 8, 1), 0.2, jnp.float32)
    _, _, losses = fit(np.asarray(target), mats, init, tf, steps=60,
                       learning_rate=0.1, params=params)
    assert losses[-1] < losses[0] * 0.1


def test_multiview_fit_beats_single_view():
    """Fitting from 3 orbit views reduces loss on all views."""
    from vpt_jax.runtime.animators import OrbitCameraAnimator
    from vpt_jax.scene import default_camera

    tf = transfer.gray_ramp(alpha_scale=1.0)
    params = eam.Params(slices=12, random=False)
    target_vol = volume.blobs_volume(8, seed=4)

    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    views, targets = [], []
    for yaw in (0.0, 2.1, 4.2):
        orbit.yaw = yaw
        orbit._update_camera()
        cs = CameraState.from_nodes(cam)
        mats = (cs.mvp_inverse, cs.model_view, cs.projection)
        views.append(mats)
        targets.append(render_eam(target_vol.data, tf, mats, params,
                                  jnp.float32(0.0), 20, 20))

    init = jnp.full((8, 8, 8, 1), 0.2, jnp.float32)
    _, _, losses = fit(targets, views, init, tf, steps=50,
                       learning_rate=0.1, params=params)
    assert losses[-1] < losses[0] * 0.15


def test_fit_mc_recovers_tf_alpha():
    """MC inverse rendering (BASELINE config 3 structure): recover the TF
    opacity of a homogeneous volume from an MCM-rendered target."""
    from vpt_jax.renderers import diff_mc, make_scene, mcm
    from vpt_jax.train import fit_mc

    vol = volume.Volume(jnp.ones((4, 4, 4, 1), jnp.float32))
    target_alpha = 0.45
    tf_target = jnp.zeros((2, 2, 4), jnp.float32).at[..., 3].set(target_alpha)
    sc = make_scene(vol, tf_target, pack=False)
    params = mcm.Params(extinction=4.0, steps=24)
    n = 6
    target = diff_mc.mcm_expected_image(sc, params, n, n, frames=150)

    tf_init = jnp.zeros((2, 2, 4), jnp.float32).at[..., 3].set(0.15)
    _, tf_fit, losses = fit_mc(target, sc, init_tf=tf_init, params=params,
                               frames=60, steps=40, learning_rate=0.03)
    assert losses[-1] < losses[0] * 0.3
    # the homogeneous volume samples the TF only at (value=1, y=0): compare
    # the fitted opacity where the renderer actually reads it
    from vpt_jax import sampling

    got = float(sampling.sample_texture2d(
        tf_fit, jnp.array([[1.0, 0.0]]))[0, 3])
    assert abs(got - target_alpha) < 0.12, got
