"""Ray/volume sampling primitives — the "shader stdlib" of the framework.

JAX re-implementations of the reference's GLSL mixins:

- ``intersect_cube``  — slab test vs the unit cube (mixins/intersectCube.glsl:3-12)
- ``unproject``       — NDC → texture-space ray via inverse MVP (mixins/unproject.glsl:3-11)
- ``unproject_rand``  — stochastic DoF + AA variant (mixins/unprojectRand.glsl:3-24)
- ``sample_volume``   — trilinear 3D texture fetch, CLAMP_TO_EDGE + LINEAR
                        (the GL sampler state set in Volume.js:52-57)
- ``sample_transfer`` — bilinear 2D transfer-function lookup
- ``sample_volume_color`` — the composite ``TF(volume(p).rg)`` primitive every
                        renderer shares (e.g. MCMRenderer.glsl:85-89)
- ``sample_environment`` — equirectangular env-map lookup (MCMRenderer.glsl:80-83)
- ``henyey_greenstein``  — HG phase sampling (MCMRenderer.glsl:91-106)

Everything is batched over arbitrary leading dimensions, float32, and
differentiable w.r.t. the volume and transfer-function textures (the gathers
transpose to scatter-adds, which is exactly the voxel/TF-texel gradient).
"""

from __future__ import annotations

import functools

import numpy as _np
import jax
import jax.numpy as jnp

from . import rng

EPS = _np.float32(1e-5)
INVPI = _np.float32(0.31830988618)


# ---------------------------------------------------------------------------
# Ray setup
# ---------------------------------------------------------------------------

def intersect_cube(origin, direction):
    """Slab-test ray/unit-cube intersection → (..., 2) = (tnear, tfar)."""
    tmin = (0.0 - origin) / direction
    tmax = (1.0 - origin) / direction
    t1 = jnp.minimum(tmin, tmax)
    t2 = jnp.maximum(tmin, tmax)
    tnear = jnp.max(t1, axis=-1)
    tfar = jnp.min(t2, axis=-1)
    return jnp.stack([tnear, tfar], axis=-1)


def intersect_box(origin, direction, lo, hi):
    """Slab-test ray/AABB intersection → (..., 2) = (tnear, tfar);
    ``lo``/``hi`` are (3,) box corners in the same space as ``origin``
    (the occupied-interval march clamp, skipgrid.occupied_aabb)."""
    tmin = (lo - origin) / direction
    tmax = (hi - origin) / direction
    t1 = jnp.minimum(tmin, tmax)
    t2 = jnp.maximum(tmin, tmax)
    tnear = jnp.max(t1, axis=-1)
    tfar = jnp.min(t2, axis=-1)
    return jnp.stack([tnear, tfar], axis=-1)


from .math3d import apply_mat4  # exact elementwise mat4 apply (no matmul)


def unproject(ndc, mvp_inverse):
    """NDC position (..., 2) → (from, to) ray endpoints in texture space."""
    ndc = jnp.asarray(ndc, jnp.float32)
    ones = jnp.ones(ndc.shape[:-1] + (1,), jnp.float32)
    near = jnp.concatenate([ndc, -ones, ones], axis=-1)
    far = jnp.concatenate([ndc, ones, ones], axis=-1)
    f = apply_mat4(mvp_inverse, near)
    t = apply_mat4(mvp_inverse, far)
    return f[..., :3] / f[..., 3:4], t[..., :3] / t[..., 3:4]


def unproject_rand(state, ndc, mvp_inverse, inverse_resolution, blur):
    """Stochastic unproject: disk jitter on the near plane (depth of field),
    square jitter on the far plane (antialiasing).  Consumes 4 uniforms from
    ``state`` in the same order as the GLSL."""
    state, disk_offset = rng.disk(state)
    state, aa = rng.square(state)
    near_xy = ndc + disk_offset * blur
    far_xy = ndc + (aa * 2.0 - 1.0) * inverse_resolution
    ones = jnp.ones(ndc.shape[:-1] + (1,), jnp.float32)
    near = jnp.concatenate([near_xy, -ones, ones], axis=-1)
    far = jnp.concatenate([far_xy, ones, ones], axis=-1)
    f = apply_mat4(mvp_inverse, near)
    t = apply_mat4(mvp_inverse, far)
    return state, f[..., :3] / f[..., 3:4], t[..., :3] / t[..., 3:4]


def pixel_ndc(height, width):
    """NDC coordinates of pixel centers, (H, W, 2); row 0 is the bottom of
    the image (y up, OpenGL convention)."""
    y = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0 - 1.0
    x = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    xx, yy = jnp.meshgrid(x, y)
    return jnp.stack([xx, yy], axis=-1)


# ---------------------------------------------------------------------------
# Texture sampling
# ---------------------------------------------------------------------------

def _gather3d(volume, ix, iy, iz):
    """volume: (D, H, W, C); indices already clamped int32 arrays."""
    d, h, w, _ = volume.shape
    flat = volume.reshape(d * h * w, -1)
    idx = (iz * h + iy) * w + ix
    return jnp.take(flat, idx, axis=0)


def sample_volume(volume, position):
    """Trilinear fetch of a (D, H, W, C) texture at (..., 3) xyz positions in
    [0, 1] — GL LINEAR + CLAMP_TO_EDGE semantics (texel i center at
    (i + 0.5) / N).  Out-of-range positions clamp to the edge."""
    d, h, w, _ = volume.shape
    dims = jnp.array([w, h, d], jnp.float32)
    # GL CLAMP_TO_EDGE clamps the filter coordinate so the fraction is 0 at
    # the edges (both taps read the edge texel exactly)
    u = jnp.clip(position * dims - 0.5, 0.0, dims - 1.0)
    i0 = jnp.floor(u)
    f = u - i0
    i0 = i0.astype(jnp.int32)
    i1 = i0 + 1
    maxi = jnp.array([w - 1, h - 1, d - 1], jnp.int32)
    i0 = jnp.clip(i0, 0, maxi)
    i1 = jnp.clip(i1, 0, maxi)

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]

    c000 = _gather3d(volume, x0, y0, z0)
    c100 = _gather3d(volume, x1, y0, z0)
    c010 = _gather3d(volume, x0, y1, z0)
    c110 = _gather3d(volume, x1, y1, z0)
    c001 = _gather3d(volume, x0, y0, z1)
    c101 = _gather3d(volume, x1, y0, z1)
    c011 = _gather3d(volume, x0, y1, z1)
    c111 = _gather3d(volume, x1, y1, z1)

    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def sample_volume_nearest(volume, position):
    """NEAREST + CLAMP_TO_EDGE fetch (Volume.setFilter('nearest') parity)."""
    d, h, w, _ = volume.shape
    dims = jnp.array([w, h, d], jnp.float32)
    u = jnp.clip(position * dims, 0.0, dims - 0.5)
    i = u.astype(jnp.int32)
    maxi = jnp.array([w - 1, h - 1, d - 1], jnp.int32)
    i = jnp.clip(i, 0, maxi)
    return _gather3d(volume, i[..., 0], i[..., 1], i[..., 2])


def sample_volume_cubic(volume, position):
    """Smoothstep-warped trilinear ≈ cubic filter
    (mixins/quasiCubicSampling.glsl:3-9)."""
    d, h, w, _ = volume.shape
    dims = jnp.array([w, h, d], jnp.float32)
    u = position * dims + 0.5
    f = u - jnp.floor(u)
    u = jnp.floor(u) + f * f * (3.0 - 2.0 * f)
    return sample_volume(volume, (u - 0.5) / dims)


def sample_texture2d(texture, uv):
    """Bilinear fetch of an (H, W, C) texture at (..., 2) uv in [0, 1],
    CLAMP_TO_EDGE."""
    h, w, _ = texture.shape
    dims = jnp.array([w, h], jnp.float32)
    u = jnp.clip(uv * dims - 0.5, 0.0, dims - 1.0)
    i0 = jnp.floor(u)
    f = u - i0
    i0 = i0.astype(jnp.int32)
    i1 = i0 + 1
    maxi = jnp.array([w - 1, h - 1], jnp.int32)
    i0 = jnp.clip(i0, 0, maxi)
    i1 = jnp.clip(i1, 0, maxi)

    flat = texture.reshape(h * w, -1)

    def gather(ix, iy):
        return jnp.take(flat, iy * w + ix, axis=0)

    fx, fy = f[..., 0:1], f[..., 1:2]
    c00 = gather(i0[..., 0], i0[..., 1])
    c10 = gather(i1[..., 0], i0[..., 1])
    c01 = gather(i0[..., 0], i1[..., 1])
    c11 = gather(i1[..., 0], i1[..., 1])
    c0 = c00 * (1 - fx) + c10 * fx
    c1 = c01 * (1 - fx) + c11 * fx
    return c0 * (1 - fy) + c1 * fy


# ---------------------------------------------------------------------------
# Corner-packed fast samplers
#
# The fast path packs all 8 trilinear corner values of each cell into one
# contiguous row ("corner volume", (D·H·W, 8·C)) and all 4 bilinear corners
# of each TF cell into another ((TH·TW, 4·4)): one row gather per event
# instead of twelve scattered ones, at 8× the volume's memory.  Results are
# bit-identical to the reference sampler (same corner values, same lerps).
# ---------------------------------------------------------------------------

def pack_corner_volume(volume, fold_log2: int = 0):
    """(D, H, W, C) → (D·H·W, 8·C) rows of the 2×2×2 cell corners.

    Corner order: (z, y, x) minor-to-major x, matching _corner_weights.
    Clamped at the +1 edges (CLAMP_TO_EDGE semantics).

    ``fold_log2`` > 0 folds F = 1 << fold_log2 consecutive x cells into one
    (D·H·W/F, F·8·C) row (requires W % F == 0) — the layout whose backward
    scatter stays below the row-count cliff (see the fold note above); use
    :func:`scatter_fold_log2` to pick it.  :func:`sample_volume_packed`
    detects the fold from the static row count."""
    d, h, w, c = volume.shape
    vp = jnp.concatenate([volume, volume[:, :, -1:]], axis=2)
    vp = jnp.concatenate([vp, vp[:, -1:]], axis=1)
    vp = jnp.concatenate([vp, vp[-1:]], axis=0)
    corners = [vp[dz:dz + d, dy:dy + h, dx:dx + w]
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    packed = jnp.stack(corners, axis=3)          # (D, H, W, 8, C)
    if fold_log2:
        if w % (1 << fold_log2):
            raise ValueError(f"fold {1 << fold_log2} does not divide W={w}")
        return packed.reshape(d * h * (w >> fold_log2), (8 * c) << fold_log2)
    return packed.reshape(d * h * w, 8 * c)


# -- folded corner tables: dodging the backward scatter cliff ---------------
#
# The backward of a row gather is a scatter-add, whose per-row cost has the
# same total-row-count cliff as the gather's (benchmarks/scatter_cost.py:
# 15 ns/row at <=2^18 rows -> 43 ns/row in-loop at 2^21, 84 at 2^24).
# Scatter-adding a zero-padded *wide* row is exact, so the cliff can be
# dodged by folding the table to <=2^18 rows that each hold F consecutive
# cells (F = 1 << fold_log2): the forward gathers one wide row and selects
# the cell with an exact one-hot sum; the backward scatters wide rows below
# the cliff (benchmarks/scatter_fold.py: 42.5 -> 19.6 ns/row at 2^21,
# 83.6 -> 44.0 at 2^24).  The fold must live in the PRIMAL table layout —
# a per-gather custom-VJP unfold re-pays the layout shuffle every event
# iteration and loses everything (benchmarks/_unfold_probe.py); folded in
# the primal, the cotangent stays folded across the whole event loop and
# unfolds once per grad step inside the pack's own VJP.

_SCATTER_FOLD_ROWS_LOG2 = 18
# Folded rows wider than one native lane tile cost more to gather and to
# one-hot-select than their scatter saves (measured in the real MCM
# backward at 256^3: fold 16 -> 128-lane rows wins +37%; fold 64 ->
# 512-lane rows loses), so the lane cap beats full de-cliffing.
_SCATTER_FOLD_MAX_LANES = 128


def twolevel_folds(rows: int, lanes: int, width: int):
    """(table_fold_log2, gather_fold_log2) for the two-level fold: store
    the table at whatever fold brings its rows under the scatter cliff
    (NO lane cap — gathers are served at ``gather_fold_log2`` through
    :func:`take_rows_twolevel` and never read the wide rows), and gather
    at fold 0 (the fastest measured gather layout inside grad loops).
    Returns (0, None) when the table is already below the cliff."""
    del lanes  # the scatter-side width is uncapped by design
    b = max(0, (rows - 1).bit_length() - _SCATTER_FOLD_ROWS_LOG2)
    while b > 0 and width % (1 << b):
        b -= 1
    return b, (0 if b else None)


def scatter_fold_log2(rows: int, lanes: int, width: int) -> int:
    """Fold factor (log2) that brings a ``rows``-row table of ``lanes``-lane
    rows under the scatter cliff, capped by the max folded-row width and by
    the x-extent ``width`` (folds group consecutive x cells)."""
    f = max(0, (rows - 1).bit_length() - _SCATTER_FOLD_ROWS_LOG2)
    while f > 0 and ((lanes << f) > _SCATTER_FOLD_MAX_LANES
                     or width % (1 << f)):
        f -= 1
    return f


# -- two-level fold: fast-fold gathers, cliff-free-fold scatters ------------
#
# The forward gather and the backward scatter-add prefer DIFFERENT folds:
# gathers are fastest near the unfolded layout (narrow rows; the in-loop
# event stream already sits near the per-row floor), while scatters need
# <=2^18 rows to stay below their (steeper) cliff.  A custom-VJP gather
# decouples them: the PRIMAL table lives at the scatter-friendly fold
# (bwd_fold rows wide), the forward internally reshapes it to the
# gather-friendly fold (a free, loop-hoisted relayout — both layouts tile
# f32 exactly) and gathers there, and the backward one-hot-expands each
# cotangent row into its position inside the wide bwd row and scatters
# below the cliff.  The loop-carried table cotangent then stays in the wide
# layout across the whole event loop — the per-iteration relayout that
# killed the naive unfold (benchmarks/_unfold_probe.py) never happens —
# and unfolds once per grad step inside pack_corner_volume's own VJP.


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5))
def take_rows_twolevel(table, idx, fwd_fold_log2: int, bwd_fold_log2: int,
                       bwd_rows: int, bwd_lanes: int):
    """Gather rows ``idx`` (indices into the fwd_fold layout) from a table
    stored at bwd_fold (requires bwd_fold_log2 >= fwd_fold_log2;
    ``(bwd_rows, bwd_lanes)`` = the table's static shape).  Value-identical
    to ``jnp.take`` on the fwd_fold reshape of ``table``; the cotangent
    scatter-adds in the bwd_fold layout (below the row-count cliff) with
    one-hot zero-padded wide update rows — exact under addition."""
    shift = bwd_fold_log2 - fwd_fold_log2
    fwd_view = table.reshape(table.shape[0] << shift, -1)
    return jnp.take(fwd_view, idx, axis=0)


def _take_twolevel_fwd(table, idx, fwd_fold_log2, bwd_fold_log2,
                       bwd_rows, bwd_lanes):
    out = take_rows_twolevel(table, idx, fwd_fold_log2, bwd_fold_log2,
                             bwd_rows, bwd_lanes)
    return out, idx


def _take_twolevel_bwd(fwd_fold_log2, bwd_fold_log2, bwd_rows, bwd_lanes,
                       idx, ct):
    shift = bwd_fold_log2 - fwd_fold_log2
    flat_ct = ct.reshape(-1, ct.shape[-1])
    flat_idx = idx.reshape(-1)
    zeros = jnp.zeros((bwd_rows, bwd_lanes), ct.dtype)
    if shift == 0:
        grad = zeros.at[flat_idx].add(flat_ct, mode="promise_in_bounds")
        return grad, None
    sub = flat_idx & ((1 << shift) - 1)       # position inside the wide row
    onehot = (sub[:, None]
              == jnp.arange(1 << shift, dtype=jnp.int32)).astype(ct.dtype)
    wide = (onehot[:, :, None] * flat_ct[:, None, :]).reshape(
        flat_idx.shape[0], bwd_lanes)
    grad = zeros.at[flat_idx >> shift].add(wide, mode="promise_in_bounds")
    return grad, None


take_rows_twolevel.defvjp(_take_twolevel_fwd, _take_twolevel_bwd)


def _take_corner_rows(packed, idx, total_rows: int,
                      gather_fold_log2: int | None = None):
    """The row-fetch half of :func:`gather_packed_corners`: validate the
    table layout and gather the (possibly folded) rows holding cell ``idx``.
    Returns ``(rows, eff_fold)`` — the un-selected wide rows and the number
    of cells each one holds."""
    if total_rows % packed.shape[0]:
        raise ValueError(
            f"corner table rows {packed.shape[0]} do not divide the cell "
            f"count {total_rows} — table/volume_shape mismatch")
    fold = total_rows // packed.shape[0]          # static; 1 = unfolded
    if fold & (fold - 1):
        raise ValueError(f"fold factor {fold} is not a power of two — "
                         "table/volume_shape mismatch")
    fold_log2 = fold.bit_length() - 1
    if gather_fold_log2 is not None and gather_fold_log2 < fold_log2:
        if fold == 1:
            raise ValueError("gather_fold_log2 given for an unfolded table")
        gf = gather_fold_log2
        rows = take_rows_twolevel(packed, idx >> gf, gf, fold_log2,
                                  packed.shape[0], packed.shape[1])
        eff_fold = 1 << gf
    elif fold == 1:
        rows = jnp.take(packed, idx, axis=0)
        eff_fold = 1
    else:
        rows = jnp.take(packed, idx >> fold_log2, axis=0)
        eff_fold = fold
    return rows, eff_fold


def gather_packed_corners(packed, idx, total_rows: int, c: int,
                          gather_fold_log2: int | None = None):
    """Fetch cell ``idx``'s 8 corner values from a (possibly folded) corner
    table as float32 (..., 8, c).  The fold factor is detected from the
    static row count: ``total_rows`` is the unfolded cell count.

    ``gather_fold_log2``: serve the gather at a different (smaller) fold
    than the table's own — the two-level fold (take_rows_twolevel): fast
    narrow-row gathers in the forward, cliff-free wide-row scatters in the
    backward.  None = gather at the table's fold (the plain path)."""
    rows, eff_fold = _take_corner_rows(packed, idx, total_rows,
                                       gather_fold_log2)
    if eff_fold > 1:
        wide = rows.reshape(rows.shape[:-1] + (eff_fold, 8 * c))
        # exact cell select: elementwise one-hot sum (picks one term; no
        # matmul so no bf16 operand quantization of float32 tables)
        sub = idx & (eff_fold - 1)
        onehot = (sub[..., None] == jnp.arange(eff_fold, dtype=jnp.int32))
        rows = jnp.sum(wide * onehot[..., None].astype(wide.dtype), axis=-2)
    return rows.astype(jnp.float32).reshape(rows.shape[:-1] + (8, c))


# -- fused select+lerp VJP: emit the folded cotangent row directly ----------
#
# Reverse-mode through the plain combine transposes the one-hot cell select
# and the three lerp levels SEPARATELY, per event, inside the scan: the lerp
# transpose rebuilds the (..., 8, C) corner cotangent through strided
# interleaves (the transpose of rows[..., 0::2, :] is an even-lane pad) and
# the select transpose then re-expands it into the wide folded row.  But the
# Jacobian of the whole combine w.r.t. the gathered row is just
# onehot(sub) ⊗ w8(f) — the trilinear corner weights — so the cotangent is
# ONE fused outer product ct_wide = onehot ⊗ w8 ⊗ ct.  _select_trilerp pins
# the forward to the bit-identical select+lerp chain and supplies that
# analytic backward; the gathered row is NOT a residual (the weights need
# only sub and f), so the per-event residual stream shrinks too.
#
# Contract: positions are treated as DETACHED (ct_f = 0, so d/d position
# through the fetch is dropped).  That is already the MC gradient
# estimators' semantics — diff_mc stop-gradients every position input (the
# reset/flight carries), so position tangents are symbolic zeros there —
# but it makes this an OPT-IN (Scene(fused_vjp=True) / fit paths), not the
# default: the plain path remains the full-Jacobian oracle.  Contract and
# grad equality are pinned by tests/test_fused_vjp.py.


def _trilerp_chain(rows, f):
    """The exact 3-level lerp of sample_volume_packed (bit-identical)."""
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    # corner order: ((z0,z1) x (y0,y1) x (x0,x1)), x minor
    cx = rows[..., 0::2, :] * (1 - fx)[..., None] \
        + rows[..., 1::2, :] * fx[..., None]          # (..., 4, C)
    cy = cx[..., 0::2, :] * (1 - fy)[..., None] \
        + cx[..., 1::2, :] * fy[..., None]            # (..., 2, C)
    return cy[..., 0, :] * (1 - fz) + cy[..., 1, :] * fz


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def _select_trilerp(rows, sub, f, eff_fold: int, c: int):
    """One-hot cell select (eff_fold > 1) + trilinear lerp over gathered
    corner rows — value bit-identical to the plain
    gather_packed_corners-then-lerp path, backward fused (see note above)."""
    if eff_fold > 1:
        wide = rows.reshape(rows.shape[:-1] + (eff_fold, 8 * c))
        onehot = (sub[..., None] == jnp.arange(eff_fold, dtype=jnp.int32))
        rows = jnp.sum(wide * onehot[..., None].astype(wide.dtype), axis=-2)
    rows = rows.astype(jnp.float32).reshape(rows.shape[:-1] + (8, c))
    return _trilerp_chain(rows, f)


def _select_trilerp_fwd(rows, sub, f, eff_fold, c):
    out = _select_trilerp(rows, sub, f, eff_fold, c)
    # the gathered rows are NOT saved — only a 0-size dtype token
    return out, (sub, f, jnp.zeros((0,), rows.dtype))


def _select_trilerp_bwd(eff_fold, c, res, ct):
    sub, f, dtype_token = res
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    wx = jnp.stack([1.0 - fx, fx], axis=-1)           # (..., 2)
    wy = jnp.stack([1.0 - fy, fy], axis=-1)
    wz = jnp.stack([1.0 - fz, fz], axis=-1)
    # corner order (z, y, x), x minor — matches pack_corner_volume
    w8 = (wz[..., :, None, None] * wy[..., None, :, None]
          * wx[..., None, None, :]).reshape(f.shape[:-1] + (8,))
    ct8 = w8[..., :, None] * ct[..., None, :]          # (..., 8, c)
    if eff_fold > 1:
        onehot = (sub[..., None]
                  == jnp.arange(eff_fold, dtype=jnp.int32)).astype(ct.dtype)
        ct_rows = (onehot[..., :, None]
                   * ct8.reshape(ct8.shape[:-2] + (1, 8 * c))).reshape(
                       sub.shape + (eff_fold * 8 * c,))
    else:
        ct_rows = ct8.reshape(sub.shape + (8 * c,))
    return (ct_rows.astype(dtype_token.dtype),
            _np.zeros(sub.shape, jax.dtypes.float0),   # int index: no grad
            jnp.zeros_like(f))                         # detached positions


_select_trilerp.defvjp(_select_trilerp_fwd, _select_trilerp_bwd)


def sample_volume_packed(packed, shape, position,
                         gather_fold_log2: int | None = None,
                         fused_vjp: bool = False):
    """Trilinear fetch from a corner-packed volume (one gather per sample).

    ``packed``: output of :func:`pack_corner_volume` (optionally folded —
    detected from its static row count); ``shape``: (D, H, W, C);
    ``gather_fold_log2``: serve gathers at a smaller fold than the table's
    (the two-level fold — see :func:`gather_packed_corners`).
    ``fused_vjp``: emit the select+lerp cotangent as one fused outer
    product and treat positions as detached (see _select_trilerp — the MC
    grad estimators' contract; value is bit-identical either way).
    Identical results to :func:`sample_volume`."""
    d, h, w, c = shape
    dims = jnp.array([w, h, d], jnp.float32)
    # clamp to [0, dims-1]: at the low edge f collapses to 0 so the packed
    # (i0, i0+1) corner pair reproduces the both-corners-clamped slow path
    u = jnp.clip(position * dims - 0.5, 0.0, dims - 1.0)
    i0 = jnp.floor(u)
    f = u - i0
    i0 = jnp.clip(i0.astype(jnp.int32), 0,
                  jnp.array([w - 1, h - 1, d - 1], jnp.int32))
    idx = (i0[..., 2] * h + i0[..., 1]) * w + i0[..., 0]
    if fused_vjp:
        raw, eff_fold = _take_corner_rows(packed, idx, d * h * w,
                                          gather_fold_log2)
        sub = idx & (eff_fold - 1)
        return _select_trilerp(raw, sub, f, eff_fold, c)
    rows = gather_packed_corners(packed, idx, d * h * w, c,
                                 gather_fold_log2=gather_fold_log2)
    return _trilerp_chain(rows, f)


# Max rows per one-hot matmul; (rows, TW) weights cap at ~128 MB bf16.
_MXU_CHUNK_ROWS = 1 << 18


def pack_mxu_transfer(transfer, dtype=jnp.bfloat16):
    """(TH, TW, 4) transfer function → (TW, 4) one-hot matmul lookup
    table.

    For single-channel volumes the TF's second coordinate is always 0
    (``texture(uTransferFunction, vec2(value, 0))``), so the bilinear 2D
    lookup collapses to a 1D piecewise-linear table over row y=0, which
    this path evaluates as a bilinear-weight matmul instead of a gather."""
    return jnp.asarray(transfer[0], dtype)


def sample_transfer_1d_mxu(table, value):
    """Piecewise-linear 1D TF lookup as a one-hot matmul.

    ``table``: (TW, C) from :func:`pack_mxu_transfer`; ``value``: (...) in
    [0, 1].  Equivalent to ``sample_texture2d(tf, [value, 0])`` up to the
    table/weight dtype (bf16 weights quantize the lerp fraction to ~2⁻⁸ —
    the same order as the reference's 8-bit TF texture coordinates)."""
    tw, c = table.shape
    u = jnp.clip(value * tw - 0.5, 0.0, tw - 1.0)
    flat = u.reshape(-1)                                 # (N,)
    # float32 tables must not quantize through TF32, which a float32 matmul
    # on the GPU may use at default precision; bf16 tables are the
    # intentional quantized fast path.
    precision = (jax.lax.Precision.HIGHEST
                 if table.dtype == jnp.float32 else None)

    def lookup(rows):
        idx = jax.lax.broadcasted_iota(jnp.float32, (rows.shape[0], tw), 1)
        weights = jnp.clip(1.0 - jnp.abs(rows[:, None] - idx), 0.0, 1.0)
        return jnp.dot(weights.astype(table.dtype), table,
                       preferred_element_type=jnp.float32,
                       precision=precision)

    # The (N, TW) one-hot weight matrix is the whole memory cost of this path;
    # cap it by looping the matmul over row chunks for very large batches
    # (march renderers flatten 8·H·W rows at once).
    n, chunk = flat.shape[0], _MXU_CHUNK_ROWS
    if n <= chunk:
        out = lookup(flat)
    else:
        pad = (-n) % chunk
        padded = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])
        out = jax.lax.map(lookup, padded.reshape(-1, chunk))
        out = out.reshape(-1, c)[:n]
    return out.reshape(value.shape + (c,))


def pack_corner_texture2d(texture):
    """(H, W, C) → (H·W, 4·C) rows of the 2×2 texel corners (x minor)."""
    h, w, c = texture.shape
    tp = jnp.concatenate([texture, texture[:, -1:]], axis=1)
    tp = jnp.concatenate([tp, tp[-1:]], axis=0)
    corners = [tp[dy:dy + h, dx:dx + w] for dy in (0, 1) for dx in (0, 1)]
    packed = jnp.stack(corners, axis=2)          # (H, W, 4, C)
    return packed.reshape(h * w, 4 * c)


def sample_texture2d_packed(packed, shape, uv):
    """Bilinear fetch from a corner-packed 2D texture (one gather)."""
    h, w, c = shape
    dims = jnp.array([w, h], jnp.float32)
    u = jnp.clip(uv * dims - 0.5, 0.0, dims - 1.0)
    i0 = jnp.floor(u)
    f = u - i0
    i0 = jnp.clip(i0.astype(jnp.int32), 0,
                  jnp.array([w - 1, h - 1], jnp.int32))
    rows = jnp.take(packed, i0[..., 1] * w + i0[..., 0], axis=0)
    rows = rows.astype(jnp.float32).reshape(rows.shape[:-1] + (4, c))
    fx, fy = f[..., 0:1], f[..., 1:2]
    cx = rows[..., 0::2, :] * (1 - fx)[..., None] \
        + rows[..., 1::2, :] * fx[..., None]          # (..., 2, C)
    return cx[..., 0, :] * (1 - fy) + cx[..., 1, :] * fy


def volume_rg(volume, position, filter="linear"):
    """``texture(uVolume, p).rg`` — (value, gradient-magnitude) pair; the
    second channel reads 0 for single-channel volumes (GL RED format)."""
    if filter == "nearest":
        s = sample_volume_nearest(volume, position)
    elif filter == "cubic":
        s = sample_volume_cubic(volume, position)
    else:
        s = sample_volume(volume, position)
    if s.shape[-1] >= 2:
        return s[..., :2]
    return jnp.concatenate([s, jnp.zeros_like(s)], axis=-1)


def sample_volume_color(volume, tf, position, filter="linear"):
    """The shared composite sampler: trilinear 3D fetch feeding a bilinear 2D
    transfer-function lookup (MCMRenderer.glsl:85-89 et al.) → (..., 4)."""
    return sample_texture2d(tf, volume_rg(volume, position, filter))


def sample_environment(env, direction):
    """Equirectangular environment lookup (MCMRenderer.glsl:80-83):
    uv = (atan2(d.x, -d.z), 2·asin(-d.y)) / (2π, 2π) + 0.5."""
    d = direction
    u = jnp.arctan2(d[..., 0], -d[..., 2]) * INVPI * 0.5 + 0.5
    v = jnp.arcsin(jnp.clip(-d[..., 1], -1.0, 1.0)) * 2.0 * INVPI * 0.5 + 0.5
    return sample_texture2d(env, jnp.stack([u, v], axis=-1))


# ---------------------------------------------------------------------------
# Shading helpers
# ---------------------------------------------------------------------------

def central_value_gradient(sample_color_fn, position, h):
    """Central-difference gradient of TF alpha through any color sampler
    (ISORenderer.glsl:165-177) — the single implementation behind
    Scene/HaloScene.value_gradient."""
    offs = jnp.eye(3, dtype=jnp.float32) * h
    grads = [sample_color_fn(position + offs[i])[..., 3]
             - sample_color_fn(position - offs[i])[..., 3]
             for i in range(3)]
    return jnp.stack(grads, axis=-1) / (2.0 * h)


def central_raw_gradient(sample_value_fn, position, voxel_size):
    """LAO's negated central difference of the raw value
    (LAORenderer.glsl:73-80)."""
    offs = jnp.eye(3, dtype=jnp.float32) * jnp.asarray(voxel_size,
                                                       jnp.float32)
    grads = [sample_value_fn(position - offs[i])
             - sample_value_fn(position + offs[i])
             for i in range(3)]
    return jnp.stack(grads, axis=-1)


def value_gradient(volume, tf, position, h):
    """Central-difference gradient of the TF alpha channel over raw
    volume/tf arrays."""
    return central_value_gradient(
        lambda p: sample_volume_color(volume, tf, p), position, h)


def raw_gradient(volume, position, voxel_size):
    """Central-difference gradient of the raw volume value — LAO
    convention."""
    return central_raw_gradient(
        lambda p: sample_volume(volume, p)[..., 0], position, voxel_size)


def henyey_greenstein_cosine(state, g):
    """HG scattering-angle cosine (MCMRenderer.glsl:91-95)."""
    state, u = rng.uniform(state)
    g2 = g * g
    c = (1.0 - g2) / (1.0 - g + 2.0 * g * u)
    return state, (1.0 + g2 - c * c) / (2.0 * g)


def henyey_greenstein(state, g, direction):
    """Sample an HG-distributed direction around ``direction``
    (MCMRenderer.glsl:97-106).  ``g`` may be traced (a GL-uniform-like
    dynamic parameter): like the shader, the isotropic |g| < EPS case returns
    the raw sphere sample and consumes one fewer uniform — the RNG state is
    selected accordingly so stream semantics match the GLSL in both cases."""
    state_sphere, u = rng.sphere(state)
    iso = jnp.abs(jnp.asarray(g, jnp.float32)) < EPS
    g_safe = jnp.where(iso, jnp.float32(0.5), g)
    state_hg, hgcos = henyey_greenstein_cosine(state_sphere, g_safe)
    proj = jnp.sum(u * direction, axis=-1, keepdims=True)
    perp = u - proj * direction
    circle = perp / jnp.sqrt(
        jnp.maximum(jnp.sum(perp * perp, axis=-1, keepdims=True), 1e-12))
    hgcos = hgcos[..., None]
    hg_dir = jnp.sqrt(jnp.maximum(1.0 - hgcos * hgcos, 0.0)) * circle \
        + hgcos * direction
    return (jnp.where(iso, state_sphere, state_hg),
            jnp.where(iso, u, hg_dir))


def max3(v):
    return jnp.max(v, axis=-1)


def mean3(v):
    return jnp.mean(v, axis=-1)
