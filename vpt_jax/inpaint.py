"""Occlusion-aware volume completion for inverse rendering.

The config-3 forensics (docs/ARCHITECTURE.md "Config-3 null space")
measured that after a multi-view fit all *optically visible* material
recovers 28x while blob cores — 1.1% of voxels behind optical depth >> 1
from every view — are a physical gradient null space: radiance
measurements do not constrain them, and in-loop stiff smoothness
penalties cannot move them either (Adam's per-step motion is bounded by
the learning rate, and the biharmonic/tri-harmonic flows checkerboard
under per-voxel normalization).  This module completes the null space
*directly*: detect the unobserved set from the fitted volume itself,
then solve the prior's Euler-Lagrange equation on that set exactly
(conjugate gradients on the quadratic `mean(lap^2)` form) instead of
descending it.

Why biharmonic, and why log space: the minimizer of ∫(Δu)² with the
observed shell frozen is the quadratic continuation of the shell's value
AND slope (harmonic fill is bounded by the boundary max — it can never
rebuild a peak).  A Gaussian blob is exactly quadratic in log space, so
log-domain biharmonic completion reproduces a Gaussian core from its
visible skirt exactly; clipped-plateau cores are also penalty-free
(Δ log v = 0 there).

The reference (MOj0/vpt) has no inverse pipeline at all — this is a
vpt_jax extension past parity (the transport being inverted is
MCMRenderer.glsl:129-166's).

Pieces (all jittable; python loops only over pyramid levels / chunks):
- ``optical_depth_min6`` / ``unobserved_mask``: cheap conservative proxy
  for multi-orbit-view visibility — cumulative optical depth along the
  six axis directions (pure cumsums, no gathers), min over directions.
  Orbit captures see the volume from all sides, so a voxel whose
  *best* axis direction already exceeds ``tau`` is treated as unseen.
- ``optical_depth_views``: the view-aware field —
  optical depth integrated along the ACTUAL capture rays (camera
  centers from ``camera_position``), min over views; makes tau physical
  (~1 = transmittance e⁻¹) instead of the proxy's swept 0.15.
- ``select_tau_blind``: truth-free threshold
  choice by held-out-view reprojection — fills as much as possible
  without measurable held-out harm.
- ``biharmonic_fill``: coarse-to-fine CG solve of Δ²u = 0 on the masked
  voxels with the rest frozen.
- ``complete_occluded``: mask + fill in one call.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["optical_depth_min6", "optical_depth_views", "unobserved_mask",
           "biharmonic_fill", "complete_occluded", "camera_position",
           "select_tau_blind"]


def _density(volume):
    return volume[..., 0] if volume.ndim == 4 else volume


def optical_depth_min6(volume, extinction: float):
    """Min over the six axis directions of the accumulated optical depth
    from the volume boundary to each voxel (exclusive of the voxel).

    The volume spans the unit cube, so the per-step length is 1/n per
    axis.  Exact for axis-aligned rays; a conservative proxy for the
    best orbit view (any real view's depth >= the best direction's up to
    path-length factors, stated assumption of the detector)."""
    rho = _density(volume)
    od = None
    for axis in range(3):
        h = extinction / rho.shape[axis]
        cs = jnp.cumsum(rho, axis=axis) * h
        fwd = cs - rho * h          # exclusive prefix: depth *to* the voxel
        rev = cs[_last_slice(rho, axis)] - cs  # exclusive suffix
        for d in (fwd, rev):
            od = d if od is None else jnp.minimum(od, d)
    return od


def _last_slice(x, axis):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(-1, None)
    return tuple(idx)


def unobserved_mask(volume, extinction: float, tau: float = 3.0):
    """Voxels whose best axis-aligned view exceeds optical depth ``tau``
    (transmittance < e^-tau): the data null space to complete."""
    return optical_depth_min6(volume, extinction) > tau


def camera_position(model_view):
    """Camera center in normalized texture space: the origin of camera
    space mapped back through inv(V·M·center) — the same transform ISO
    uses for its light (ISORenderer.js:157-165).  All capture rays of a
    pinhole view pass through this point."""
    from . import math3d as m4

    return m4.transform_point(m4.invert(model_view),
                              jnp.zeros((3,), jnp.float32))


def optical_depth_views(volume, extinction, camera_positions,
                        n_steps: int = 64, grid: int | None = 128,
                        chunk: int = 8):
    """Min over the ACTUAL capture views of the accumulated optical depth
    from the cube boundary to each voxel — the view-aware visibility
    field that replaces the 6-axis
    proxy of :func:`optical_depth_min6`.

    For each voxel center p and camera center o (``camera_positions``,
    (V, 3) in texture space — :func:`camera_position`), integrates
    ``extinction · ρ`` along the segment from the cube entry of the ray
    o→p to p (midpoint rule, ``n_steps`` samples, exclusive of p by
    construction of the midpoints).  This is the transmittance the
    capture radiance actually attenuated through, so the "unseen" test
    ``min_v od_v > tau`` has its physical meaning and tau ≈ 1 is the
    natural threshold — unlike the axis proxy, whose optimum on fitted
    volumes sat at 0.15 (docs/ARCHITECTURE.md "Occlusion completion").

    ``grid``: compute at this resolution (volume down-sampled, result
    up-sampled) — the field is smooth and full-resolution integration at
    256³ × many views is needlessly expensive.  None = native.
    ``chunk``: z-planes per jitted dispatch (memory bound)."""
    from . import sampling

    rho = _density(volume)
    d, h, w = rho.shape
    cams = jnp.asarray(camera_positions, jnp.float32)
    if cams.ndim == 1:
        cams = cams[None]
    if grid is None:
        gd, gh, gw = d, h, w
    else:
        scale = min(1.0, grid / max(d, h, w))
        gd, gh, gw = (max(1, round(d * scale)), max(1, round(h * scale)),
                      max(1, round(w * scale)))
    rho_g = rho if (gd, gh, gw) == (d, h, w) \
        else jax.image.resize(rho, (gd, gh, gw), "trilinear")
    rho4 = rho_g[..., None]

    def centers(n):
        return (jnp.arange(n, dtype=jnp.float32) + 0.5) / n

    zs_all, ys, xs = centers(gd), centers(gh), centers(gw)
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")

    @functools.partial(jax.jit, static_argnames=())
    def plane_od(zval, cam):
        pts = jnp.stack([xx, yy, jnp.full_like(xx, zval)],
                        axis=-1).reshape(-1, 3)
        dvec = pts - cam
        tb = sampling.intersect_cube(jnp.broadcast_to(cam, pts.shape),
                                     dvec)
        t0 = jnp.clip(tb[..., 0], 0.0, 1.0)
        dt = (1.0 - t0) / n_steps
        ts = t0[:, None] + (jnp.arange(n_steps, dtype=jnp.float32)
                            + 0.5)[None, :] * dt[:, None]
        x = cam + ts[..., None] * dvec[:, None, :]
        dens = sampling.volume_rg(rho4, x, "linear")[..., 0]
        seg = jnp.sqrt(jnp.sum(dvec * dvec, axis=-1)) * dt
        return extinction * jnp.sum(dens, axis=1) * seg

    out = []
    for z0 in range(0, gd, chunk):
        zs = zs_all[z0:z0 + chunk]
        planes = None
        for cam in cams:
            od = jnp.stack([plane_od(z, cam).reshape(gh, gw)
                            for z in zs])
            planes = od if planes is None else jnp.minimum(planes, od)
        out.append(planes)
    od_g = jnp.concatenate(out, axis=0)
    if (gd, gh, gw) != (d, h, w):
        od_g = jax.image.resize(od_g, (d, h, w), "trilinear")
    return od_g


def select_tau_blind(volume, taus, heldout_targets, render_views_fn,
                     depth=None, extinction=None, slack: float = 0.02,
                     slack_abs: float = 0.0, **fill_kwargs):
    """Choose the completion threshold WITHOUT ground truth: for each
    candidate tau, complete the volume and re-render
    HELD-OUT capture views (views the fit never saw).

    Selection rule: held-out reprojection can only *veto* — a genuinely
    unobserved voxel is (by definition) nearly invisible from every
    capture-like view, so correct fills are reprojection-neutral, while
    OVER-masking replaces observed material with extrapolation and shows
    up as held-out error.  The blind choice is therefore the largest
    filled fraction whose held-out MSE stays within ``slack`` of the
    best row (including the no-fill row): fill as much as possible
    without measurable harm.

    ``render_views_fn(volume) -> (V, H, W, C) or list``: renders the
    held-out views; ``heldout_targets``: their captured images;
    ``depth``: a visibility field (:func:`optical_depth_views` of the
    FIT views is the physical choice) — falls back to the 6-axis proxy
    at ``extinction``.

    ``slack``/``slack_abs``: a row is admissible when its held-out MSE
    ≤ floor·(1+slack) + slack_abs.  The absolute term matters for
    noiseless/synthetic captures, where the floor is ~quantization and a
    correct fill still leaks ~e⁻tau of transmittance into the render;
    with real MC captures the noise floor makes the relative term
    sufficient.

    Returns ``(best_tau, completed, table)``; ``best_tau`` is None (and
    ``completed`` the untouched fit) when every fill hurts."""
    v = _density(volume)
    if depth is None:
        if extinction is None:
            raise ValueError("need depth or extinction")
        depth = optical_depth_min6(v, extinction)

    def as_stack(x):
        return jnp.stack([jnp.asarray(p) for p in x]) \
            if isinstance(x, (list, tuple)) else jnp.asarray(x)

    tgt = as_stack(heldout_targets)

    def score(vol):
        pred = as_stack(render_views_fn(vol))
        return float(jnp.mean((pred[..., :3] - tgt[..., :3]) ** 2))

    # first pass scores every candidate WITHOUT retaining its volume
    # (seven 256³ fills would pin ~0.5 GB); the winner is refilled once
    table = [{"tau": None, "filled_frac": 0.0, "heldout_mse": score(v)}]
    for tau in taus:
        mask = depth > tau
        filled = biharmonic_fill(v, mask, **fill_kwargs)
        table.append({"tau": float(tau),
                      "filled_frac": float(mask.mean()),
                      "heldout_mse": score(filled)})
        del filled
    floor = min(r["heldout_mse"] for r in table)
    admissible = [r for r in table
                  if r["heldout_mse"] <= floor * (1.0 + slack)
                  + slack_abs]
    best = max(admissible, key=lambda r: r["filled_frac"])
    if best["tau"] is None:
        completed = v
    else:
        completed = biharmonic_fill(v, depth > best["tau"],
                                    **fill_kwargs)
    completed = completed[..., None] if volume.ndim == 4 else completed
    return best["tau"], completed, table


def _lap(u):
    return sum(jnp.roll(u, -1, a) + jnp.roll(u, 1, a) - 2.0 * u
               for a in range(3))


def _cg_fill(u0, mask, iters: int):
    """CG on J(x) = sum(lap(u)^2), u = where(mask, x, u0) — quadratic and
    SPD on the mask subspace, so CG converges where gradient descent on
    the same penalty measurably stalls (docs/ARCHITECTURE.md).  Fixed
    iteration count (no data-dependent control flow under jit)."""
    mask = mask.astype(u0.dtype)

    def matvec(x):
        return mask * _lap(_lap(x * mask))

    b = -mask * _lap(_lap(u0 * (1.0 - mask)))
    x = u0 * mask
    r = b - matvec(x)
    p = r

    def body(_, carry):
        x, r, p, rs = carry
        ap = matvec(p)
        denom = jnp.vdot(p, ap)
        alpha = jnp.where(denom > 0, rs / jnp.maximum(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        beta = rs_new / jnp.maximum(rs, 1e-30)
        return x, r, r + beta * p, rs_new

    x, _, _, _ = lax.fori_loop(
        0, iters, body, (x, r, p, jnp.vdot(r, r)))
    return u0 * (1.0 - mask) + x * mask


@functools.partial(jax.jit, static_argnames=("iters",))
def _level_fill(u, mask, iters):
    return _cg_fill(u, mask, iters)


def biharmonic_fill(volume, mask, log_space: bool = True,
                    floor: float = 0.01, coarsest: int = 32,
                    cg_iters: int = 200, clip: bool = True):
    """Fill ``mask`` voxels with the biharmonic (Δ²u = 0) continuation of
    the unmasked data, coarse-to-fine from ``coarsest`` with CG at every
    level (coarse levels propagate across whole cores in a few cheap
    iterations; the fine level polishes near the boundary).

    ``log_space`` solves on log(max(v, floor)) — exact for Gaussian
    cores (quadratic in log) — then exponentiates the filled region."""
    v = _density(volume)
    u = jnp.log(jnp.maximum(v, floor)) if log_space else v
    n = v.shape[0]
    levels = []
    lv = min(coarsest, n)
    while lv < n:
        levels.append(lv)
        lv *= 2
    levels.append(n)

    filled = None
    for lv in levels:
        ul = u if lv == n else jax.image.resize(u, (lv,) * 3, "trilinear")
        ml = mask if lv == n else (
            jax.image.resize(mask.astype(jnp.float32), (lv,) * 3,
                             "trilinear") > 0.5)
        if filled is not None:
            up = jax.image.resize(filled, (lv,) * 3, "trilinear")
            ul = jnp.where(ml, up, ul)  # carry the coarse fill down
        filled = _level_fill(ul, ml, cg_iters)
    out = jnp.where(mask, jnp.exp(filled) if log_space else filled, v)
    if clip:
        out = jnp.clip(out, 0.0, 1.0)
    return out[..., None] if volume.ndim == 4 else out


def complete_occluded(volume, extinction: float = None, tau: float = None,
                      depth=None, **fill_kwargs):
    """Detect the unobserved set of ``volume`` and fill it with the
    log-domain biharmonic continuation of the observed material.
    Returns ``(completed_volume, mask)``.

    ``depth``: a visibility field — pass :func:`optical_depth_views` of
    the actual capture cameras for the physical threshold (default
    tau = 1.0: transmittance < e⁻¹ from every view).  Without it, the
    6-axis proxy at ``extinction`` is used with default tau = 0.15 — the
    committed config-3 sweep optimum (docs/ARCHITECTURE.md "Occlusion
    completion": masks from a FITTED volume need tau far below 1 because
    underfilled cores under-report their own occlusion; the basin
    [0.1, 0.2] is broad).  To choose tau
    without ground truth, see :func:`select_tau_blind`."""
    if depth is None:
        if extinction is None:
            raise ValueError("need depth or extinction")
        depth = optical_depth_min6(volume, extinction)
        tau = 0.15 if tau is None else tau
    else:
        tau = 1.0 if tau is None else tau
    mask = depth > tau
    return biharmonic_fill(volume, mask, **fill_kwargs), mask
