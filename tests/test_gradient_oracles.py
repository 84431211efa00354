"""Tight-tolerance gradient oracles for the detached-decision MC estimators.

The round-1 gradient tests (test_diff_mc.py) validate *statistical* means at
15-25% tolerance, because the score-function part of the gradient only exists
in expectation.  These tests split the gradient into its two parts and pin
each one tightly:

1. **Pathwise part** (continuous factors: transmittance tints, TF colors):
   with the score weights frozen (``score_floor=1.0``), the estimator is a
   piecewise-smooth deterministic function of the scene for fixed seeds, so
   common-random-numbers finite differences must match AD at FD-truncation
   error (~1e-3 in float32), not at a statistical bar.  Caveat measured on
   this code: the tangent evaluation and the FD primals MUST share one jit —
   compiled in different fusion contexts, borderline float comparisons flip
   a few discrete branch outcomes and the comparison is garbage (the same
   effect that rules out jax.checkpoint, see diff_mc.mcm_expected_image).

2. **Score part** (discrete decision probabilities): CRN finite differences
   are *structurally blind* to it — the ratio weights w = p/stop_grad(p)
   equal 1 at every θ, so FD over them is identically zero (measured: FD of
   the full estimator is stable across ε decades at a value AD correctly
   rejects).  The only exact oracle is an expectation.  We build one with no
   statistics at all: RNG draws are injected via monkeypatching so each
   pixel realizes one *enumerated path family* through a homogeneous slab,
   where every family's probability is closed-form.  The probability-
   weighted sum of per-pixel AD tangents must equal the derivative of the
   closed-form expectation at float precision (~1e-7, vs the 1e-4 bar of
   BASELINE.md).

Reference semantics under test: the null-collision event machine of
MCMRenderer.glsl:129-166 and the delta-tracking loops of
MCSRenderer.glsl:70-105, as re-derived in renderers/diff_mc.py.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from vpt_jax import rng as vrng, sampling, transfer, volume
from vpt_jax.renderers import diff_mc, make_scene, mcm, mcs
from vpt_jax.renderers import mcm as mcm_mod


# ---------------------------------------------------------------------------
# 1. Pathwise gradients: CRN finite differences at FD-truncation tolerance
# ---------------------------------------------------------------------------

def _crn_fd_check(f, voxels, v, eps=3e-3, atol=1.5e-3, min_active=3):
    """Assert per-pixel CRN-FD == per-pixel AD jvp under one shared jit.

    Pixels whose FD is inconsistent across ε and ε/2 crossed a discrete
    branch boundary inside the window (the jumps are the score term leaking
    into FD — excluded by construction, they are validated separately by
    the exact enumeration oracle below)."""

    @jax.jit
    def ad_and_vals(voxels, eps):
        _, d = jax.jvp(f, (voxels,), (v,))
        return d, f(voxels + eps * v), f(voxels - eps * v)

    d_ad, fp, fm = ad_and_vals(voxels, eps)
    d_ad = np.asarray(d_ad)
    d1 = (np.asarray(fp) - np.asarray(fm)) / (2 * eps)
    _, fp2, fm2 = ad_and_vals(voxels, eps / 2)
    d2 = (np.asarray(fp2) - np.asarray(fm2)) / eps
    consistent = np.abs(d1 - d2) <= 2e-3 * np.maximum(np.abs(d1), 1.0) + 2e-4

    assert consistent.mean() > 0.8, consistent.mean()
    err = np.abs(d1 - d_ad)[consistent]
    assert err.max() < atol, err.max()
    # non-vacuity: the comparison must cover pixels with real gradients
    active = (np.abs(d_ad[consistent]) > 5e-3).sum()
    assert active >= min_active, active


def test_mcm_pathwise_crn_fd_tight():
    vol = volume.sphere_volume(8)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    template = make_scene(vol, tf, pack=False)
    params = mcm.Params(extinction=10.0, steps=8)

    def f(voxels):
        sc = dataclasses.replace(template, volume=voxels)
        img = diff_mc.mcm_expected_image(sc, params, 12, 12, frames=2,
                                         score_floor=1.0)
        return img[..., 0].ravel()

    voxels = template.volume
    rng_np = np.random.default_rng(0)
    v = rng_np.standard_normal(voxels.shape).astype(np.float32)
    v = jnp.asarray(v / np.linalg.norm(v))
    _crn_fd_check(f, voxels, v)


def test_mcs_pathwise_crn_fd_tight():
    vol = volume.sphere_volume(8)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    template = make_scene(vol, tf, pack=False)
    params = mcs.Params(extinction=6.0)

    def f(voxels):
        sc = dataclasses.replace(template, volume=voxels)
        img = diff_mc.mcs_expected_image(sc, params, 12, 12, frames=2,
                                         track_steps=32, score_floor=1.0)
        return img[..., 0].ravel()

    voxels = template.volume
    rng_np = np.random.default_rng(1)
    v = rng_np.standard_normal(voxels.shape).astype(np.float32)
    v = jnp.asarray(v / np.linalg.norm(v))
    _crn_fd_check(f, voxels, v)


def test_mcs_score_floor_preserves_values():
    """The score floor only touches gradients: w == 1 in value either way."""
    sc = make_scene(volume.sphere_volume(8),
                    jnp.zeros((2, 2, 4), jnp.float32)
                    .at[..., 3].set(0.5).at[..., :3].set(0.7), pack=False)
    params = mcs.Params(extinction=5.0)
    a = diff_mc.mcs_generate(sc, params, jnp.float32(0.3), 8, 8)
    b = diff_mc.mcs_generate(sc, params, jnp.float32(0.3), 8, 8,
                             score_floor=1.0)
    assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# 2. Score machinery: exact enumeration oracle (no statistics)
# ---------------------------------------------------------------------------
#
# Setup: homogeneous unit volume, constant TF (rgb=(c,.3,.2), alpha=a), all
# photons start at p0=(.5,.5,z0) moving +z, white 1x1 environment, global
# majorant σ̄.  Exit distance L = 1−z0.  Branch probabilities at any event:
#   p_scatter = a·max3(rgb) = a·c,  p_absorb = a·(1−c),  p_null = 1−a.
# Because the medium is homogeneous, every enumerated path family's measure
# is a closed-form atom (the free-path integrals collapse):
#   P(exit immediately)                = e^{−σ̄L}
#   P(k in-range events, then exit)    = (σ̄L)^k/k! · e^{−σ̄L}   (per event
#     sequence; multiply by each event's branch probability)
#   P(ever in-range)                   = 1 − e^{−σ̄L}
# Families enumerated (one pixel each, steps=3, single completed path each —
# the per-path deposit expectation is the quantity the detached-decision
# estimator is unbiased for):
#   A: exit@1                                   → deposit 1
#   B: absorb@1                                 → deposit 0
#   C: null@1, exit@2                           → deposit w (score: p_null)
#   D: scatter@1, exit@2                        → deposit c·w (score:
#        p_scatter; pathwise: the tint c)
#   E: null@1, scatter@2, exit@3                → deposit c·w (two scores)
# Expected red radiance over these families:
#   F(a,c) = e^{−σ̄L} + (1−a)·K1 + a·c²·K1 + (1−a)·a·c²·K2,
#   K1 = σ̄L·e^{−σ̄L},  K2 = (σ̄L)²/2·e^{−σ̄L}
# and Σ_family P(family)·AD[deposit] must equal ∇F exactly: the ratio
# weights carry d log p per decision, so P·(deposit·Σd log p + ∂deposit)
# = d(P·deposit) term by term.
#
# The HG sampler is patched to keep the direction (its measure is
# θ-independent, so it carries no score term; patching it keeps the slab
# geometry 1-D and the atoms closed-form).  Draws are injected by patching
# rng.exponential (returns raw distances — the free-path measure is
# accounted test-side) and rng.uniform (returns branch representatives).

_SIGMA = 2.0
_Z0 = 0.1
_L = 1.0 - _Z0
_A0, _C0 = 0.4, 0.6
_H, _W = 1, 5
_NSLOT = 6          # 2 draw slots per event x 3 events
_IN, _OUT = 0.15, 10.0


def _draw_tables():
    pa = _A0 * (1.0 - _C0)
    ps = _A0 * _C0
    rep_absorb = pa / 2
    rep_scatter = pa + ps / 2
    rep_null = pa + ps + (1 - pa - ps) / 2
    dist = np.zeros((_NSLOT, _H, _W), np.float32)
    uni = np.full((_NSLOT, _H, _W), rep_null, np.float32)
    dist[:, 0, 0] = [_OUT, 0, _IN, 0, _IN, 0]     # A: exit@1
    dist[:, 0, 1] = [_IN, 0, _IN, 0, _IN, 0]      # B: absorb@1
    uni[1, 0, 1] = rep_absorb
    dist[:, 0, 2] = [_IN, 0, _OUT, 0, _IN, 0]     # C: null@1, exit@2
    dist[:, 0, 3] = [_IN, 0, _OUT, 0, _IN, 0]     # D: scatter@1, exit@2
    uni[1, 0, 3] = rep_scatter
    dist[:, 0, 4] = [_IN, 0, _IN, 0, _OUT, 0]     # E: null@1, scatter@2,
    uni[3, 0, 4] = rep_scatter                    #    exit@3
    return jnp.asarray(dist), jnp.asarray(uni)


def test_mcm_score_machinery_exact(monkeypatch):
    dist_tab, uni_tab = _draw_tables()
    p0 = jnp.broadcast_to(jnp.array([0.5, 0.5, _Z0], jnp.float32),
                          (_H, _W, 3))
    d0 = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32),
                          (_H, _W, 3))

    monkeypatch.setattr(
        vrng, "seed_pixels",
        lambda mapped, seed, **kw: jnp.zeros(mapped.shape[:-1], jnp.int32))
    monkeypatch.setattr(
        vrng, "exponential",
        lambda state, rate: (state + 1, jnp.take_along_axis(
            dist_tab, jnp.clip(state, 0, _NSLOT - 1)[None], axis=0)[0]))
    monkeypatch.setattr(
        vrng, "uniform",
        lambda state, hash_fn=None: (state + 1, jnp.take_along_axis(
            uni_tab, jnp.clip(state, 0, _NSLOT - 1)[None], axis=0)[0]))
    monkeypatch.setattr(mcm_mod, "_photon_reset",
                        lambda state, ndc, scene, params, inv_res:
                        (state, p0, d0))
    monkeypatch.setattr(sampling, "henyey_greenstein",
                        lambda state, g, direction: (state, direction))

    vol = volume.Volume(jnp.ones((4, 4, 4, 1), jnp.float32))
    params = mcm.Params(extinction=_SIGMA, steps=3)

    def per_pixel_red(theta, score_floor=None):
        a, c = theta
        tf = jnp.stack([jnp.full((2, 2), c), jnp.full((2, 2), 0.3),
                        jnp.full((2, 2), 0.2), jnp.full((2, 2), a)],
                       axis=-1)
        sc = make_scene(vol, tf, pack=False)
        state = {
            "position": p0, "direction": d0,
            "bounces": jnp.zeros((_H, _W), jnp.float32),
            "transmittance": jnp.ones((_H, _W, 3), jnp.float32),
            "radiance": jnp.zeros((_H, _W, 3), jnp.float32),
            "samples": jnp.zeros((_H, _W), jnp.float32),
            "logw": jnp.zeros((_H, _W), jnp.float32),
        }
        out = diff_mc.mcm_render_frame(state, sc, params, jnp.float32(0.0),
                                       jnp.int32(1), score_floor=score_floor)
        return out["radiance"][0, :, 0], out["samples"][0]

    e1 = float(np.exp(-_SIGMA * _L))
    k1 = _SIGMA * _L * e1
    k2 = (_SIGMA * _L) ** 2 / 2 * e1
    pa, ps, pn = _A0 * (1 - _C0), _A0 * _C0, 1 - _A0
    weights = jnp.asarray([e1, (1 - e1) * pa, pn * k1, ps * k1,
                           pn * ps * k2], jnp.float32)

    def estimator(theta, score_floor=None):
        r, _ = per_pixel_red(theta, score_floor)
        return jnp.sum(weights * r)

    def closed_form(theta):
        a, c = theta
        return (e1 + (1.0 - a) * k1 + a * c * c * k1
                + (1.0 - a) * a * c * c * k2)

    theta0 = jnp.array([_A0, _C0], jnp.float32)
    r, s = per_pixel_red(theta0)
    # each pixel realized its designed family: one completed path each,
    # deposits (1, 0, 1, c, c)
    assert np.array_equal(np.asarray(s), np.ones(_W, np.float32))
    assert np.allclose(np.asarray(r), [1.0, 0.0, 1.0, _C0, _C0], atol=1e-6)

    assert abs(float(estimator(theta0)) - float(closed_form(theta0))) < 1e-6
    g_est = np.asarray(jax.grad(estimator)(theta0))
    g_cf = np.asarray(jax.grad(closed_form)(theta0))
    np.testing.assert_allclose(g_est, g_cf, atol=1e-6)

    # score_floor semantics, pinned exactly: with floor = 0.5, the scatter
    # (p = a·c = 0.24) and absorb (p = 0.16) decision scores are dropped
    # while the null score (p = 1−a = 0.6) survives — the expected gradient
    # is ∇ of the closed form with the scatter-probability factors detached
    # (the pathwise tint c still flows):
    def closed_form_floored(theta):
        a, c = theta
        ps_detached = lax.stop_gradient(a * c)
        return (e1 + (1.0 - a) * k1 + ps_detached * c * k1
                + (1.0 - a) * ps_detached * c * k2)

    assert abs(float(estimator(theta0, 0.5)) - float(closed_form(theta0))) \
        < 1e-6  # values never change
    g_fl = np.asarray(jax.grad(lambda t: estimator(t, 0.5))(theta0))
    g_fl_cf = np.asarray(jax.grad(closed_form_floored)(theta0))
    np.testing.assert_allclose(g_fl, g_fl_cf, atol=1e-6)
    # floor >= 1 freezes every score term: only the pathwise tint remains
    g_pw = np.asarray(jax.grad(lambda t: estimator(t, 1.0))(theta0))
    g_pw_cf = np.asarray(jax.grad(
        lambda t: (e1 + lax.stop_gradient(1.0 - t[0]) * k1
                   + lax.stop_gradient(t[0] * t[1]) * t[1] * k1
                   + lax.stop_gradient((1.0 - t[0]) * t[0] * t[1])
                   * t[1] * k2))(theta0))
    np.testing.assert_allclose(g_pw, g_pw_cf, atol=1e-6)
