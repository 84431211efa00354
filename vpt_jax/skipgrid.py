"""Super-voxel majorant grid: local-majorant null-collision tracking.

An acceleration with no reference counterpart: the reference's
MCM kernel (src/glsl/renderers/MCMRenderer.glsl:129-166) tracks against a
single *global* majorant (uExtinction, with TF alpha as the local ratio),
so photons crossing nearly-empty space burn one null-collision event per
global mean free path.  This module builds a coarse N³ grid over the
normalized [0,1]³ volume storing, per cell:

- ``maxalpha``: a conservative upper bound of the transfer-function alpha
  anywhere in the cell's *trilinear support* (voxels dilated by one) — the
  TF alpha is maximized over every texel the bilinear lookup can touch for
  any interpolated value in the cell's [vmin, vmax] range, which bounds
  non-monotone TFs correctly (interpolated volume values are convex
  combinations of corner values; piecewise-linear alpha over an interval
  is bounded by the covering texels' max).
- ``chebdist``: the Chebyshev distance (in cells) to the nearest cell with
  maxalpha > 0 (0 for such cells themselves), enabling multi-cell hops
  through exactly-empty space.

The tracking loop (renderers/mcm.py with ``make_scene(majorant_grid=N)``)
samples free paths against mu_cell = extinction·maxalpha instead of the
global extinction, hopping cell boundaries by DDA when the tentative
collision falls outside the current cell (valid by memorylessness of the
exponential), and classifies collisions with the ratio alpha/maxalpha in
place of the reference's alpha.  Distributionally this is the same
null-collision estimator — it only removes collisions that were certain
to be null — but it consumes a different per-pixel RNG stream than the
GLSL-exact machine, so it is an opt-in performance mode validated
statistically (tests/test_skipgrid.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Cell-indexing nudge along the ray (normalized units).  Positions landing
# exactly on a cell face index the *next* cell; collisions in the 1e-5
# sliver behind a face may rate against the neighbor's majorant, which the
# ratio clip in the tracking loop bounds conservatively.
EPS_NUDGE = 1e-5


def build_majorant_grid(volume, transfer, n_cells: int):
    """(D, H, W, C) volume + (TH, TW, 4) transfer → (N, N, N, 2) float32
    [maxalpha, chebdist] grid, or None when unsupported.

    Single-channel volumes only (the TF is then sampled at uv = (value, 0),
    texel row 0 — MCMRenderer.glsl:85-89); cell windows must tile the voxel
    grid exactly (dims divisible by n_cells)."""
    d, h, w, c = volume.shape
    if c != 1:
        return None
    if d % n_cells or h % n_cells or w % n_cells:
        return None
    bz, by, bx = d // n_cells, h // n_cells, w // n_cells
    v = volume[..., 0]

    def pooled(op, init):
        return lax.reduce_window(
            v, init, op,
            window_dimensions=(bz + 2, by + 2, bx + 2),
            window_strides=(bz, by, bx),
            padding=((1, 1), (1, 1), (1, 1)))

    vmin = pooled(lax.min, jnp.float32(jnp.inf))
    vmax = pooled(lax.max, jnp.float32(-jnp.inf))

    # TF texels a bilinear lookup at uv=(value, 0) can touch for any value
    # in [vmin, vmax]: u = value·TW − 0.5, corners floor(u) and floor(u)+1.
    tw = transfer.shape[1]
    alpha_row = transfer[0, :, 3]                        # (TW,)
    lo = jnp.clip(jnp.floor(vmin * tw - 0.5), 0, tw - 1)
    hi = jnp.clip(jnp.floor(vmax * tw - 0.5) + 1.0, 0, tw - 1)
    t = jax.lax.broadcasted_iota(jnp.float32, (n_cells ** 3, tw), 1)
    in_range = (t >= lo.reshape(-1, 1)) & (t <= hi.reshape(-1, 1))
    maxalpha = jnp.max(jnp.where(in_range, alpha_row, 0.0), axis=1)
    maxalpha = maxalpha.reshape(n_cells, n_cells, n_cells)
    occupied = maxalpha > 0.0

    # Chebyshev distance transform by iterated 3³ dilation.
    dist = jnp.where(occupied, 0.0, float(n_cells))
    reach = occupied
    for k in range(1, n_cells):
        reach = lax.reduce_window(
            reach, False, lax.bitwise_or,
            window_dimensions=(3, 3, 3), window_strides=(1, 1, 1),
            padding=((1, 1), (1, 1), (1, 1)))
        dist = jnp.minimum(dist, jnp.where(reach, float(k),
                                           float(n_cells)))
    return jnp.stack([maxalpha, dist.astype(jnp.float32)], axis=-1)


# ---------------------------------------------------------------------------
# Voxel-resolution Chebyshev empty-space skipping ("cheb-skip")
#
# The majorant grid above costs one extra coarse gather per event, which
# lost on dense scenes when measured.  cheb-skip instead rides the skip
# information in the event loop's EXISTING volume gather: a voxel cell is
# "empty" when the transfer function assigns alpha == 0 to every value the
# trilinear interpolation can produce inside it, and an empty cell's corner
# values can never influence shading in a tracking renderer (alpha == 0
# forces a null collision regardless of color), so its corner-packed row is
# repurposed to hold -chebdist in every lane (trilinear interpolation of a
# constant row is exact, so a sampled value v < 0 identifies the cell as
# empty with chebdist == -v).  The tracking loop then extends each free
# flight to at least (chebdist - 1) voxels — provably collision-free — with
# NO extra gather and NO extra cost in occupied cells.  Like the majorant
# grid this consumes a different RNG stream than the GLSL-exact machine
# (skip events burn an exponential but no classification uniform), so it is
# an opt-in / policy-selected mode (make_scene(tracking=...)).
# ---------------------------------------------------------------------------

#: default cap on the stored Chebyshev distance (voxels); bf16 packed
#: tables represent integers exactly up to 256, and hops beyond ~1/4 of
#: the volume have negligible marginal value.
CHEB_CAP = 64


def _tf_range_max(alpha_row, lo, hi):
    """max(alpha_row[lo..hi]) for int32 index arrays lo <= hi, via a
    precomputed (TW, TW) cummax table — one tiny gather per query."""
    tw = alpha_row.shape[0]
    li = jax.lax.broadcasted_iota(jnp.int32, (tw, tw), 0)
    hj = jax.lax.broadcasted_iota(jnp.int32, (tw, tw), 1)
    masked = jnp.where(hj >= li, alpha_row[None, :], 0.0)
    table = lax.cummax(masked, axis=1)            # table[lo, hi]
    return jnp.take(table.reshape(-1), lo * tw + hi, axis=0)


def cell_empty_mask(packed_rows, transfer):
    """(R, 8) corner-value rows + (TH, TW, 4) transfer → (R,) bool: True
    where the TF alpha is exactly 0 for every value trilinear interpolation
    can produce in the cell (single-channel volumes sample the TF at
    uv=(value, 0), texel row 0 — MCMRenderer.glsl:85-89)."""
    vmin = jnp.min(packed_rows, axis=-1)
    vmax = jnp.max(packed_rows, axis=-1)
    tw = transfer.shape[1]
    alpha_row = transfer[0, :, 3]
    # texels a bilinear lookup at u = value·TW − 0.5 can touch for any
    # value in [vmin, vmax] (same bound as build_majorant_grid)
    lo = jnp.clip(jnp.floor(vmin * tw - 0.5), 0, tw - 1).astype(jnp.int32)
    hi = jnp.clip(jnp.floor(vmax * tw - 0.5) + 1.0, 0,
                  tw - 1).astype(jnp.int32)
    return _tf_range_max(alpha_row, lo, hi) == 0.0


import functools


@functools.lru_cache(maxsize=None)
def _cheb_loop(cap: int):
    """One fused, cached device loop per cap: a Python loop of ``cap``
    dilations would cost ``cap`` dispatches at scene build; a fresh
    jax.jit per call would re-trace and re-compile every scene rebuild
    (viewer TF edits)."""

    def dilate(k, carry):
        reach, dist = carry
        for axis in range(3):
            window = tuple(3 if a == axis else 1 for a in range(3))
            padding = tuple((1, 1) if a == axis else (0, 0)
                            for a in range(3))
            reach = lax.reduce_window(
                reach, False, lax.bitwise_or,
                window_dimensions=window, window_strides=(1, 1, 1),
                padding=padding)
        dist = jnp.minimum(dist, jnp.where(reach, k.astype(jnp.float32),
                                           float(cap)))
        return reach, dist

    return jax.jit(lambda r, d: lax.fori_loop(1, cap, dilate, (r, d))[1])


def chebyshev_distance(occupied, cap: int = CHEB_CAP):
    """(D, H, W) bool → float32 Chebyshev distance (in cells) to the nearest
    True cell, clamped to ``cap``; cells outside the volume count as empty
    (hops may overshoot the cube — the tracking loop's oob test catches
    them).  Iterated separable 1D dilations (an L∞ ball is a box)."""
    dist = jnp.where(occupied, 0.0, float(cap))
    if not isinstance(occupied, jax.core.Tracer) \
            and not bool(jnp.any(occupied)):
        return dist                                 # fully empty volume
    return _cheb_loop(int(cap))(occupied, dist)


def pack_tracking_volume(volume, transfer, cap: int = CHEB_CAP,
                         min_empty_fraction: float = 0.0):
    """(D, H, W, 1) volume + (TH, TW, 4) transfer → corner-packed tracking
    table (D·H·W, 8): occupied cells hold their true corner values, empty
    cells hold -chebdist in every lane.  None when unsupported (multi-
    channel volumes, or volumes with negative values — the sign bit is the
    empty-cell flag) or when fewer than ``min_empty_fraction`` of the
    cells are TF-empty (the auto policy's decline, checked BEFORE the
    Chebyshev distance transform so declined builds stay cheap)."""
    from . import sampling

    d, h, w, c = volume.shape
    if c != 1:
        return None
    if bool(jnp.min(volume) < 0.0):
        return None
    packed = sampling.pack_corner_volume(volume)          # (D·H·W, 8)
    empty = cell_empty_mask(packed, transfer)             # (R,)
    if min_empty_fraction > 0.0 and             float(jnp.mean(empty.astype(jnp.float32))) < min_empty_fraction:
        return None
    occupied = (~empty).reshape(d, h, w)
    cheb = chebyshev_distance(occupied, cap=cap).reshape(-1)
    rows = jnp.where(empty[:, None],
                     -jnp.maximum(cheb, 1.0)[:, None], packed)
    return rows


def occupied_aabb(volume, transfer):
    """(D, H, W, 1) volume + (TH, TW, 4) transfer → (2, 3) float32 AABB
    [lo, hi] in normalized (x, y, z) position coordinates covering every
    cell the transfer function can make visible — or None when unsupported
    (multi-channel) or when NO cell is TF-empty (the clamp would be a
    no-op; returning None keeps the exact march bitwise untouched).

    The march clamp: samples outside this box land in
    cells whose whole trilinear value range maps to TF alpha exactly 0
    (cell_empty_mask — the same emptiness proof cheb-skip uses), so they
    contribute nothing to any march compositor (EAM/MIP premultiply by
    alpha; Depth accumulates alpha).  Clamping the marched segment to the
    box therefore integrates the same function with the same slice count
    over a shorter support — a pure quadrature refinement, validated as
    an opt-in mode (make_scene(march_clamp=True)) like pack_dtype.

    Cell (x, y, z) covers normalized positions p with
    floor(p·W − 0.5) == x, i.e. p_x ∈ [(x+0.5)/W, (x+1.5)/W] (cells 0 and
    W−1 extend to the volume faces through CLAMP_TO_EDGE)."""
    d, h, w, c = volume.shape
    if c != 1:
        return None
    from . import sampling

    packed = sampling.pack_corner_volume(volume)
    empty = cell_empty_mask(packed, transfer)
    if not bool(jnp.any(empty)):
        return None
    return _cells_aabb((~empty).reshape(d, h, w))


def _cells_aabb(occ):
    """(D, H, W) bool cell mask → (2, 3) normalized-position AABB covering
    every True cell (the shared box derivation of occupied_aabb /
    iso_value_aabb); degenerate when no cell is True."""
    d, h, w = occ.shape
    if not bool(jnp.any(occ)):
        # nothing is visible: a degenerate box every ray misses
        return jnp.asarray([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]], jnp.float32)

    def axis_range(mask_1d, n):
        idx = jnp.nonzero(mask_1d, size=n, fill_value=-1)[0]
        mn = jnp.min(jnp.where(idx >= 0, idx, n))
        mx = jnp.max(idx)
        lo = jnp.where(mn == 0, 0.0, (mn + 0.5) / n)
        hi = jnp.where(mx == n - 1, 1.0, (mx + 1.5) / n)
        return lo, hi

    zlo, zhi = axis_range(jnp.any(occ, axis=(1, 2)), d)
    ylo, yhi = axis_range(jnp.any(occ, axis=(0, 2)), h)
    xlo, xhi = axis_range(jnp.any(occ, axis=(0, 1)), w)
    return jnp.stack([jnp.stack([xlo, ylo, zlo]),
                      jnp.stack([xhi, yhi, zhi])]).astype(jnp.float32)


def iso_value_aabb(volume, transfer, alpha_min: float):
    """(2, 3) AABB over every cell where the TF alpha can reach
    ``alpha_min`` anywhere in the cell's trilinear value range — the ISO
    march clamp's tighter box, or None when unsupported
    (multi-channel) or not useful (every cell can reach ``alpha_min``).

    ISO hits require ``sampleVolumeColor(p).a >= uIsovalue``
    (ISORenderer.glsl:68-69), so a cell whose achievable alpha maximum
    stays below ``alpha_min`` can produce no hit for any isovalue ≥
    ``alpha_min``.  The bound reuses cell_empty_mask's texel-cover
    argument with the threshold raised from 0 to ``alpha_min``; validity
    for a *traced* isovalue is enforced at sample time (renderers/iso.py
    clamps only where ``isovalue >= alpha_min`` holds in-graph)."""
    d, h, w, c = volume.shape
    if c != 1:
        return None
    from . import sampling

    packed = sampling.pack_corner_volume(volume)
    vmin = jnp.min(packed, axis=-1)
    vmax = jnp.max(packed, axis=-1)
    tw = transfer.shape[1]
    alpha_row = transfer[0, :, 3]
    lo = jnp.clip(jnp.floor(vmin * tw - 0.5), 0, tw - 1).astype(jnp.int32)
    hi = jnp.clip(jnp.floor(vmax * tw - 0.5) + 1.0, 0,
                  tw - 1).astype(jnp.int32)
    can_hit = _tf_range_max(alpha_row, lo, hi) >= alpha_min
    if bool(jnp.all(can_hit)):
        return None
    return _cells_aabb(can_hit.reshape(d, h, w))


def empty_fraction(tracking_packed) -> float:
    """Fraction of cells marked empty in a built tracking table — telemetry
    for the viewer ``/info`` endpoint (the auto policy's own decline check
    runs inside :func:`pack_tracking_volume` on the pre-transform mask,
    before any table exists)."""
    return float(jnp.mean((tracking_packed[:, 0] < -0.5).astype(jnp.float32)))


def flight_step(grid, position, direction):
    """Per-photon local-majorant flight geometry.

    Returns (maxalpha, t_bound): the current cell's conservative alpha
    majorant and the distance along ``direction`` at which the photon
    leaves the cell's majorant validity (the DDA boundary crossing,
    extended to a (chebdist−1)-cell hop through exactly-empty space).
    One coarse gather; everything else is elementwise math."""
    n = grid.shape[0]
    p_idx = position + EPS_NUDGE * direction
    cell = jnp.clip(jnp.floor(p_idx * n).astype(jnp.int32), 0, n - 1)
    flat = (cell[..., 2] * n + cell[..., 1]) * n + cell[..., 0]
    rows = jnp.take(grid.reshape(-1, 2), flat, axis=0)
    maxalpha, cheb = rows[..., 0], rows[..., 1]

    # DDA: distance to the cell face in the direction of travel, per axis.
    step_pos = direction > 0.0
    boundary = (cell.astype(jnp.float32) + step_pos) / n
    t_axis = jnp.where(direction != 0.0,
                       (boundary - position) / direction, jnp.inf)
    t_bound = jnp.min(t_axis, axis=-1)
    # exactly-empty regions: any point within (chebdist−1) cells (L∞ hence
    # L2) of this cell has alpha ≡ 0, so the hop may extend that far.
    hop_far = jnp.maximum(cheb - 1.0, 0.0) / n
    t_bound = jnp.where((maxalpha == 0.0) & (cheb >= 2.0),
                        jnp.maximum(t_bound, hop_far), t_bound)
    return maxalpha, jnp.maximum(t_bound, 0.0)
