"""DOS — directional occlusion shading via a view-aligned slice sweep.

Re-implements the reference DOS renderer (``src/glsl/renderers/
DOSRenderer.glsl`` integrate:66-82 + occlusion:56-64, JS orchestration
``DOSRenderer.js``): the volume is swept front to back in view-aligned
slices; each slice composites ``1 − exp(−σ·Δs)`` opacity modulated by a
ping-ponged occlusion buffer, and the occlusion buffer is advanced as the
mean of N disk-sample taps times the slice transmittance.

Host-side pieces of the reference move into the functional state:
- the centered-disk occlusion sample offsets (``generateOcclusionSamples``,
  DOSRenderer.js:105-138) are generated at reset from the GLSL-parity RNG;
- the per-frame depth range from the 8 box corners (``calculateDepth``,
  DOSRenderer.js:140-164) is computed from the model-view matrix in-jit;
- the per-slice NDC depth / occlusion scale (DOSRenderer.js:240-248) come
  from the projection matrix.

One ``render_frame`` advances ``steps`` slices of the ``slices``-slice sweep
(DOSRenderer.js:226-254) as a ``lax.scan``; slices past the far depth are
no-ops, mirroring the early ``break``.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from .. import math3d as m4
from .. import rng, sampling
from .base import Scene, params_dataclass, static_field


@params_dataclass
class Params:
    extinction: float = 100.0
    aperture: float = 30.0        # degrees
    steps: int = static_field(default=50)     # slices advanced per frame
    slices: int = static_field(default=200)   # total sweep resolution
    samples: int = static_field(default=8)    # occlusion disk taps


def _shifted_occlusion_taps(occlusion, offsets, occlusion_scale):
    """Mean of the N bilinear disk taps, computed WITHOUT gathers.

    Every tap's offset is uniform across pixels (``offsets[k] ·
    occlusion_scale`` does not depend on the pixel), so a bilinear fetch at
    ``pixel_center + delta`` is a uniformly shifted image read: texel
    indices are clip(p + floor(delta·dims)) — four dynamic slices of an
    edge-padded copy — and the bilinear fractions are the constant
    frac(delta·dims), zeroed where the reference sampler's CLAMP_TO_EDGE
    collapses both corners (u clipped at the borders).  Replaces the
    8 × H·W-row gathers per slice with dense elementwise work; values match
    sample_texture2d up to float-associativity ulps (the gather path
    computes u = (p+0.5)/W·W−0.5 in floats; this path uses the exact
    integer identity floor(p + delta) = p + floor(delta))."""
    h, w = occlusion.shape
    dims = jnp.array([w, h], jnp.float32)
    dd = offsets * occlusion_scale * dims              # (N, 2) texel deltas
    base = jnp.clip(jnp.floor(dd), -(w + 1), w + 1).astype(jnp.int32)
    frac = dd - base.astype(jnp.float32)               # (N, 2) in [0, 1)

    pad = max(h, w) + 2
    padded = jnp.pad(occlusion, pad, mode="edge")
    px = jnp.arange(w, dtype=jnp.int32)
    py = jnp.arange(h, dtype=jnp.int32)

    total = jnp.zeros_like(occlusion)
    for k in range(offsets.shape[0]):
        bx, by = base[k, 0], base[k, 1]
        block = lax.dynamic_slice(padded, (pad + by, pad + bx),
                                  (h + 1, w + 1))
        a00 = block[:h, :w]
        a10 = block[:h, 1:]
        a01 = block[1:, :w]
        a11 = block[1:, 1:]
        # CLAMP_TO_EDGE collapses the lerp at the borders: fx = 0 unless
        # 0 <= p + base < dims-1 (same for fy)
        in_x = (px + bx >= 0) & (px + bx <= w - 2)
        in_y = (py + by >= 0) & (py + by <= h - 2)
        fx = jnp.where(in_x, frac[k, 0], 0.0)[None, :]
        fy = jnp.where(in_y, frac[k, 1], 0.0)[:, None]
        c0 = a00 * (1 - fx) + a10 * fx
        c1 = a01 * (1 - fx) + a11 * fx
        total = total + (c0 * (1 - fy) + c1 * fy)
    return total / offsets.shape[0]


def _occlusion_samples(count: int):
    """Centered disk samples (DOSRenderer.js:105-128), deterministic."""
    state = rng.pcg(jnp.arange(2 * count, dtype=jnp.uint32) + jnp.uint32(17))
    _, sq = rng.square(state[:count])
    radius = jnp.sqrt(sq[:, 0])
    angle = sq[:, 1] * 2.0 * jnp.pi
    pts = radius[:, None] * jnp.stack([jnp.cos(angle), jnp.sin(angle)],
                                      axis=-1)
    return pts - jnp.mean(pts, axis=0, keepdims=True)


_CORNERS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.float32)


def _depth_range(model_view):
    """[min, max] of −(V·M·C · corner).z over the 8 cube corners
    (calculateDepth, DOSRenderer.js:140-164); min clamped to 0."""
    cam = m4.transform_point(model_view, _CORNERS)
    depths = -cam[:, 2]
    return jnp.maximum(jnp.min(depths), 0.0), jnp.max(depths)


def reset(params: Params, height: int, width: int, scene: Scene = None):
    assert scene is not None, "DOS reset needs the scene (depth range)"
    min_depth, max_depth = _depth_range(scene.model_view)
    return {
        "color": jnp.zeros((height, width, 4), jnp.float32),
        "occlusion": jnp.ones((height, width), jnp.float32),
        "depth": min_depth,
        "max_depth": max_depth,
        "slice_distance": (max_depth - min_depth) / params.slices,
        "offsets": _occlusion_samples(params.samples),
    }


def render_frame(state, scene: Scene, params: Params, seed, frame_number,
                 *, ndc=None, sample_occlusion=None):
    """``ndc`` / ``sample_occlusion`` are sharding hooks: a spatially
    sharded caller passes this device's global pixel NDC block and a
    halo-aware tap sampler (parallel/dos_halo.py); defaults reproduce the
    single-device behavior."""
    height, width = state["color"].shape[:2]
    if ndc is None:
        ndc = sampling.pixel_ndc(height, width)
    mapped = ndc * 0.5 + 0.5
    slice_distance = state["slice_distance"]
    occlusion_extent = slice_distance * jnp.tan(
        params.aperture * jnp.pi / 180.0)

    # The slice schedule is fixed (depth_i = depth0 + i·Δ; the carried
    # depth only ever advances on that schedule while active, and inactive
    # slices mask every write), so the volume sampling batches CHUNK
    # slices per gather — same amortization as renderers/_march.py.
    chunk = min(8, params.steps)
    n = params.steps
    padded_n = n + (-n) % chunk
    idx = jnp.arange(padded_n, dtype=jnp.float32)
    depths = state["depth"] + idx * slice_distance          # (P,)
    # per-slice NDC depth + occlusion scale: project [1, 1, -depth]
    # (DOSRenderer.js:240-248)
    corrs = m4.transform_point(
        scene.projection,
        jnp.stack([jnp.ones_like(depths), jnp.ones_like(depths),
                   -depths], axis=-1))                      # (P, 3)
    valid = (jnp.arange(padded_n) < n)

    def chunk_step(carry, xs):
        color, occlusion = carry
        depth_c, corr_c, valid_c = xs                       # (K,), (K,3)

        # slice positions in texture space (DOS integrate vertex:17-23),
        # one chunked gather for all K slices
        ndc_depth = corr_c[:, 2]
        pos3d_h = jnp.concatenate([
            jnp.broadcast_to(ndc[None], (chunk,) + ndc.shape),
            jnp.broadcast_to(ndc_depth[:, None, None, None],
                             (chunk,) + ndc.shape[:-1] + (1,)),
            jnp.ones((chunk,) + ndc.shape[:-1] + (1,), jnp.float32),
        ], axis=-1)
        pos3d = sampling.apply_mat4(scene.mvp_inverse, pos3d_h)
        pos3d = pos3d[..., :3] / pos3d[..., 3:4]
        colors = scene.sample_color(pos3d)                  # (K, H, W, 4)
        outsides = jnp.any((pos3d > 1.0) | (pos3d < 0.0), axis=-1)

        for k in range(chunk):
            active = valid_c[k] & (depth_c[k] <= state["max_depth"])
            occlusion_scale = corr_c[k, :2] * occlusion_extent
            ts = colors[k]
            extinction = ts[..., 3] * params.extinction
            alpha = 1.0 - jnp.exp(-extinction * slice_distance)
            contrib = ts[..., :3] * occlusion[..., None] * alpha[..., None]
            new_color = color + jnp.concatenate(
                [contrib * (1.0 - color[..., 3:4]), alpha[..., None]],
                axis=-1)
            new_color = new_color.at[..., 3].min(1.0)

            # occlusion: mean of disk taps on the previous occlusion
            # buffer times the slice transmittance (DOS glsl:56-64)
            if sample_occlusion is None:
                # uniform-offset taps -> gather-free shifted bilinear reads
                tap_mean = _shifted_occlusion_taps(
                    occlusion, state["offsets"], occlusion_scale)
            else:
                taps = mapped[None] + state["offsets"][:, None, None, :] \
                    * occlusion_scale
                tap_mean = jnp.mean(sample_occlusion(occlusion, taps),
                                    axis=0)
            new_occlusion = tap_mean * jnp.exp(-extinction * slice_distance)

            write = active & ~outsides[k]
            color = jnp.where(write[..., None], new_color, color)
            occlusion = jnp.where(write, new_occlusion, occlusion)
        return (color, occlusion), None

    (color, occlusion), _ = lax.scan(
        chunk_step, (state["color"], state["occlusion"]),
        (depths.reshape(-1, chunk), corrs.reshape(-1, chunk, 3),
         valid.reshape(-1, chunk)))
    n_active = jnp.sum((depths[:n] <= state["max_depth"]).astype(
        jnp.float32))
    depth = state["depth"] + n_active * slice_distance
    return dict(state, color=color, occlusion=occlusion, depth=depth)


def display(state, scene: Scene, params: Params):
    """mix(white, color, alpha) (DOS render fragment:113-116)."""
    color = state["color"]
    rgb = 1.0 + (color[..., :3] - 1.0) * color[..., 3:4]
    return jnp.concatenate(
        [rgb, jnp.ones(rgb.shape[:-1] + (1,), jnp.float32)], axis=-1)
