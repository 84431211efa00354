"""DOS under pixel-row sharding with explicit occlusion halo exchange.

DOS is the one renderer whose kernel reads neighboring *pixels*: each slice
advances a ping-ponged occlusion buffer as the mean of disk-sample taps on
the previous slice's buffer (``DOSRenderer.glsl:56-64``).  Row-sharding the
pixel grid therefore needs a halo of occlusion rows from the adjacent
shards, exchanged once per slice.

XLA's auto-partitioner handles the tap gather too, but conservatively (it
all-gathers the occlusion buffer every slice).  This module runs the sweep
under ``shard_map`` with a K-row halo exchanged by ``lax.ppermute`` — K is
the statically computed worst-case tap radius over the whole sweep, usually
a few rows, so the per-slice traffic drops from O(H·W) to O(K·W) per device
and is two neighbor exchanges instead of an all-gather.

Results are identical to the single-device renderer: taps are clamped in
*global* texture coordinates (CLAMP_TO_EDGE), then gathered from the
halo-extended local block.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import math3d as m4
from .. import sampling
from ..renderers import dos
from ..renderers.base import Scene


def occlusion_halo_width(scene: Scene, params: dos.Params,
                         height: int) -> int:
    """Worst-case occlusion tap radius in pixel rows over the whole sweep
    (static, host-side).  Bounds ``|offset_y| · occlusion_scale_y(depth)``
    over all slice depths, in texels, plus one row for the bilinear
    footprint."""
    min_d, max_d = dos._depth_range(scene.model_view)
    min_d, max_d = float(min_d), float(max_d)
    slice_distance = (max_d - min_d) / params.slices
    extent = slice_distance * math.tan(math.radians(params.aperture))
    depths = np.asarray(
        min_d + slice_distance * np.arange(params.slices), np.float64)
    # project [1, 1, -d]: y scale of the tap disk at that slice
    proj = np.asarray(scene.projection, np.float64)
    h = (proj @ np.stack([np.ones_like(depths), np.ones_like(depths),
                          -depths, np.ones_like(depths)]))
    with np.errstate(divide="ignore", invalid="ignore"):
        corr_y = np.abs(h[1] / h[3])
    if not np.isfinite(corr_y).all():
        # camera inside the volume: a slice sits at depth 0 (projection
        # w = 0), its tap radius is unbounded, and no finite halo can
        # reproduce the single-device sweep — refuse rather than diverge
        raise ValueError(
            "occlusion tap scale is unbounded (slice at depth 0 — camera "
            "inside the volume); use the auto-partitioned DOS path")
    max_scale = float(np.max(corr_y)) * extent
    offsets = np.asarray(dos._occlusion_samples(params.samples))
    max_off = float(np.max(np.abs(offsets[:, 1]))) if offsets.size else 0.0
    k = int(math.ceil(max_off * max_scale * height)) + 1
    return min(k, height)


def sharded_render_frame(mesh: Mesh, scene: Scene, params: dos.Params,
                         height: int, width: int, data_axis: str = "data",
                         donate: bool = True):
    """Build a jitted DOS frame function over ``mesh[data_axis]`` pixel-row
    shards with per-slice K-row halo exchange.

    Returns ``(frame_fn, halo_width)``; call
    ``frame_fn(state, scene, params, seed, frame_number)`` with the state
    placed by :func:`vpt_jax.parallel.shard.place_state`.  The scene must be
    replicated (DOS sweeps the full volume on every shard)."""
    n = mesh.shape[data_axis]
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by {n} shards")
    h_local = height // n
    halo = occlusion_halo_width(scene, params, height)
    if halo >= h_local:
        raise ValueError(
            f"occlusion halo {halo} rows ≥ shard height {h_local}; "
            "use fewer shards or the auto-partitioned path")

    up = [(i + 1, i) for i in range(n - 1)]      # bottom halo ← shard above
    down = [(i - 1, i) for i in range(1, n)]     # top halo ← shard below

    def exchange(occ_local):
        top = lax.ppermute(occ_local[-halo:], data_axis, down)
        bot = lax.ppermute(occ_local[:halo], data_axis, up)
        return jnp.concatenate([top, occ_local, bot], axis=0)

    def body(state, scene, params, seed, frame_number):
        row0 = lax.axis_index(data_axis) * h_local
        ndc = lax.dynamic_slice_in_dim(
            sampling.pixel_ndc(height, width), row0, h_local, axis=0)

        def sample_occlusion(occ_local, taps):
            # corner-pack the halo-extended buffer so each tap is ONE
            # gather (mirroring the single-device fast path); taps clamp
            # in GLOBAL texel space first, so CLAMP_TO_EDGE matches the
            # unsharded renderer exactly.  The halo width guarantees both
            # bilinear corners stay inside the extended block.
            ext = exchange(occ_local)
            packed = sampling.pack_corner_texture2d(ext[..., None])
            dims = jnp.array([width, height], jnp.float32)
            u = jnp.clip(taps * dims - 0.5, 0.0, dims - 1.0)
            i0 = jnp.floor(u)
            f = u - i0
            i0 = jnp.clip(i0.astype(jnp.int32), 0,
                          jnp.array([width - 1, height - 1], jnp.int32))
            local_y = i0[..., 1] - row0 + halo
            rows = jnp.take(packed, local_y * width + i0[..., 0], axis=0)
            fx, fy = f[..., 0:1], f[..., 1:2]
            cx = rows[..., 0::2] * (1 - fx) + rows[..., 1::2] * fx
            return cx[..., 0] * (1 - fy[..., 0]) + cx[..., 1] * fy[..., 0]

        return dos.render_frame(state, scene, params, seed, frame_number,
                                ndc=ndc, sample_occlusion=sample_occlusion)

    # shard only the pixel-indexed leaves by NAME — a shape test would
    # silently row-shard the (samples, 2) offsets table when
    # params.samples == height
    state_example = dos.reset(params, height, width, scene)
    st_specs = {
        k: (P(data_axis, *([None] * (v.ndim - 1)))
            if k in ("color", "occlusion") else P())
        for k, v in state_example.items()
    }

    mapped = shard_map(
        body, mesh=mesh,
        in_specs=(st_specs, P(), P(), P(), P()),
        out_specs=st_specs,
        check_vma=False,
    )
    frame_fn = jax.jit(mapped, donate_argnums=(0,) if donate else ())
    return frame_fn, halo
