"""Occlusion-aware completion (vpt_jax/inpaint.py).

Pins the two mathematical contracts the module rests on — the CG solve
reproduces the exact biharmonic continuation (quadratic fields in linear
space, Gaussian cores in log space), and the visibility proxy's
monotonic geometry — plus the end-to-end claim on the config-3 scene
family: damaged occluded cores recover from measured-visible material
alone."""

import jax.numpy as jnp
import numpy as np
import pytest

from vpt_jax import inpaint, volume


def _ball_mask(n, c=0.5, r=0.18):
    g = (np.arange(n) + 0.5) / n
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return jnp.asarray((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2
                       < r * r)


def test_quadratic_fill_is_exact():
    # Delta^2 of any quadratic is 0, so the biharmonic fill must
    # reproduce a quadratic field exactly from its complement.
    n = 48
    g = (np.arange(n) + 0.5) / n
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    quad = jnp.asarray(0.3 + 0.5 * x - 0.2 * y + 0.8 * z * z
                       - 0.4 * x * y, jnp.float32)
    mask = _ball_mask(n)
    damaged = jnp.where(mask, 0.0, quad)
    filled = inpaint.biharmonic_fill(damaged, mask, log_space=False,
                                     cg_iters=300, clip=False)
    err = np.abs(np.asarray(filled - quad))[np.asarray(mask)]
    assert err.max() < 2e-3, err.max()


def test_gaussian_core_recovers_in_log_space():
    # A Gaussian is quadratic in log space: log-domain completion
    # rebuilds the peak from the visible skirt; linear-domain biharmonic
    # (a quadratic cap on the clipped profile) is measurably worse.
    n = 64
    g = (np.arange(n) + 0.5) / n
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
    truth = jnp.asarray(0.9 * np.exp(-r2 / (2 * 0.12 ** 2)), jnp.float32)
    mask = _ball_mask(n, r=0.12)
    damaged = jnp.where(mask, 0.4 * truth, truth)
    log_fill = inpaint.biharmonic_fill(damaged, mask, log_space=True)
    lin_fill = inpaint.biharmonic_fill(damaged, mask, log_space=False)
    m = np.asarray(mask)
    mse = lambda v: float(np.mean((np.asarray(v) - np.asarray(truth))[m] ** 2))
    assert mse(log_fill) < 1e-4, mse(log_fill)
    assert mse(log_fill) < 0.5 * mse(lin_fill) + 1e-6
    # untouched outside the mask
    np.testing.assert_array_equal(np.asarray(log_fill)[~m],
                                  np.asarray(truth)[~m])


def test_unobserved_mask_geometry():
    # Uniform ball: the unobserved set is centered, grows with
    # extinction, shrinks with tau, and is empty for a thin volume.
    n = 64
    rho = _ball_mask(n, r=0.3).astype(jnp.float32)
    m_lo = inpaint.unobserved_mask(rho, extinction=5.0, tau=3.0)
    m_hi = inpaint.unobserved_mask(rho, extinction=25.0, tau=3.0)
    assert int(m_hi.sum()) > int(m_lo.sum())
    assert not bool(inpaint.unobserved_mask(rho, 0.5, tau=3.0).any())
    # monotone in tau
    m_t5 = inpaint.unobserved_mask(rho, extinction=25.0, tau=5.0)
    assert bool(jnp.all(~m_t5 | m_hi))
    # the detected set sits inside the ball, around its center
    assert bool(jnp.all(~m_hi | (rho > 0)))
    c = np.argwhere(np.asarray(m_hi)).mean(0)
    np.testing.assert_allclose(c, [n / 2 - 0.5] * 3, atol=2.0)


def test_camera_position_default_camera():
    from vpt_jax import transfer
    from vpt_jax.renderers import make_scene

    sc = make_scene(volume.sphere_volume(8), transfer.gray_ramp(),
                    pack=False)
    # default camera sits at world (0, 0, 2); texture space adds the
    # center(−0.5) offset → (0.5, 0.5, 2.5)
    np.testing.assert_allclose(np.asarray(
        inpaint.camera_position(sc.model_view)), [0.5, 0.5, 2.5],
        atol=1e-5)


def test_optical_depth_views_homogeneous_ball():
    # Uniform ball, camera on +z far away: the ball's center sees optical
    # depth ≈ extinction · ρ · radius along the near-axial ray.
    n = 48
    rho = _ball_mask(n, r=0.25).astype(jnp.float32) * 0.8
    cam = jnp.asarray([0.5, 0.5, 4.0])
    od = inpaint.optical_depth_views(rho, extinction=10.0,
                                     camera_positions=cam[None],
                                     n_steps=96, grid=None)
    center = float(od[n // 2, n // 2, n // 2])
    np.testing.assert_allclose(center, 10.0 * 0.8 * 0.25, rtol=0.1)
    # a voxel on the camera side of the ball surface is nearly free
    assert float(od[int(n * 0.78), n // 2, n // 2]) < 0.3
    # the far pole carries the whole diameter
    far = float(od[int(n * 0.27), n // 2, n // 2])
    np.testing.assert_allclose(far, 10.0 * 0.8 * 0.5, rtol=0.15)


def test_optical_depth_views_min_over_views():
    # Adding the opposite camera must cut the far-side depth to the
    # near-side profile (min over views), and can never increase it.
    n = 32
    rho = _ball_mask(n, r=0.25).astype(jnp.float32) * 0.8
    one = inpaint.optical_depth_views(
        rho, 10.0, jnp.asarray([[0.5, 0.5, 4.0]]), n_steps=64, grid=None)
    two = inpaint.optical_depth_views(
        rho, 10.0, jnp.asarray([[0.5, 0.5, 4.0], [0.5, 0.5, -3.0]]),
        n_steps=64, grid=None)
    assert bool(jnp.all(two <= one + 1e-5))
    assert float(two[int(n * 0.3), n // 2, n // 2]) \
        < 0.5 * float(one[int(n * 0.3), n // 2, n // 2])


def test_select_tau_blind_veto_and_fill():
    """The blind rule must (a) veto over-masking through held-out
    reprojection, (b) fill the vetted unobserved set, recovering the
    damaged cores without touching truth."""
    from vpt_jax import transfer
    from vpt_jax.renderers import eam, make_scene
    from vpt_jax.runtime.animators import OrbitCameraAnimator
    from vpt_jax.scene import CameraState, default_camera

    n = 48
    truth = volume.blobs_volume(n, seed=3, count=6).data[..., 0]
    ext = 25.0
    mask_true = inpaint.unobserved_mask(truth, extinction=ext, tau=2.0)
    fitted = jnp.where(mask_true, 0.45 * truth, truth)
    tf = transfer.gray_ramp(alpha_scale=1.0)
    params = eam.Params(extinction=40.0, slices=24, random=False)

    def cams(poses):
        out = []
        for yaw, pitch in poses:
            node = default_camera()
            anim = OrbitCameraAnimator(node)
            anim.rotate(np.deg2rad(yaw) / anim.rotation_speed,
                        np.deg2rad(pitch) / anim.rotation_speed)
            out.append(CameraState.from_nodes(node))
        return out

    # a NON-orbit capture (uneven yaws, mixed pitches): the view-aware
    # field needs no orbit assumption
    fit_cams = cams([(0, 10), (55, -25), (160, 35), (210, -5),
                     (305, 20)])
    held_cams = cams([(100, -15), (260, 30)])

    def render(vol, cs):
        sc = make_scene(vol[..., None], tf, camera=cs, pack=False)
        return eam.generate(sc, params, jnp.float32(0.0), 24, 24)

    targets = [render(truth, c) for c in held_cams]

    depth = inpaint.optical_depth_views(
        fitted, ext,
        jnp.stack([inpaint.camera_position(c.model_view)
                   for c in fit_cams]), n_steps=48, grid=None)

    # noiseless synthetic captures: the reprojection floor is ~1e-7 and
    # a correct fill still leaks ~e^-tau transmittance into the render,
    # so the absolute slack stands in for the capture-noise floor real
    # MC targets provide (select_tau_blind docstring)
    tau, completed, table = inpaint.select_tau_blind(
        fitted, taus=[0.02, 0.5, 1.0, 2.0, 50.0], heldout_targets=targets,
        render_views_fn=lambda v: [render(v, c) for c in held_cams],
        depth=depth, slack_abs=1e-5)
    # the absurd over-mask (0.02 masks visible shell) must be vetoed
    t002 = next(r for r in table if r["tau"] == 0.02)
    floor = min(r["heldout_mse"] for r in table)
    assert t002["filled_frac"] > 0.3
    assert t002["heldout_mse"] > floor + 1e-4
    # something real was filled, blind
    assert tau is not None and 0.02 < tau < 50.0
    mn = np.asarray(mask_true)
    tr = np.asarray(truth)
    mse0 = float(np.mean((np.asarray(fitted) - tr)[mn] ** 2))
    mse1 = float(np.mean((np.asarray(completed)[..., ] - tr)[mn] ** 2))
    assert mse1 < 0.6 * mse0, (mse0, mse1)


@pytest.mark.parametrize("tau", [2.0, 3.0])
def test_blobs_core_completion(tau):
    # End-to-end on the config-3 scene family at 64^3: damage every
    # occluded voxel the way the measured fits leave them (blurred,
    # dimmed), complete from the visible material only, and require the
    # core bucket to recover most of the damage.
    truth = volume.blobs_volume(64, seed=3, count=6).data[..., 0]
    mask = inpaint.unobserved_mask(truth, extinction=25.0, tau=tau)
    assert 0.0 < float(mask.mean()) < 0.2
    damaged = jnp.where(mask, 0.45 * truth, truth)
    filled, m2 = inpaint.complete_occluded(damaged, extinction=25.0,
                                           tau=tau)
    # m2 is recomputed on the damaged volume: damage only lowers density,
    # optical depth is monotone in density, so the recomputed unseen set
    # must be a subset of the truth-derived one (m2 ⊆ mask) — and the
    # damage pattern must still be detectable (m2 nonempty).
    assert bool(jnp.all(~m2 | mask))
    assert bool(m2.any())
    mn = np.asarray(mask)
    tr = np.asarray(truth)
    mse0 = float(np.mean((np.asarray(damaged) - tr)[mn] ** 2))
    mse1 = float(np.mean((np.asarray(filled) - tr)[mn] ** 2))
    assert mse1 < 0.25 * mse0, (mse0, mse1)


def test_optical_depth_views_non_cubic():
    # (D, H, W) with distinct extents: per-axis compute grids keep the
    # geometry (review r5 finding); output matches the input shape
    rho = jnp.zeros((24, 40, 40), jnp.float32).at[8:16, 16:28, 16:28] \
        .set(0.9)
    od = inpaint.optical_depth_views(
        rho, 10.0, jnp.asarray([[0.5, 0.5, 3.0]]), n_steps=32, grid=20)
    assert od.shape == (24, 40, 40)
    # deepest behind the block's center (low z = far from the +z camera)
    zc = np.asarray(od)[:, 22, 22]
    assert zc[4] > zc[20]
