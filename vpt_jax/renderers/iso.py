"""ISO — isosurface ray casting with deferred Lambert shading.

Re-implements the reference ISO renderer (``src/glsl/renderers/
ISORenderer.glsl``): a jittered *backward* march recording the closest
position with ``value ≥ isovalue`` (generate:52-76), a keep-the-nearer-hit
integrate (:111-121), and a deferred shade using a central-difference
gradient with h = 0.005 and a Lambert term (:165-191).  Defaults from
``ISORenderer.js:18-46`` (steps=50, isovalue=0.5, light=[2,-3,-5]); the
world-space light is mapped into texture space with ``inv(V·M·center)``
exactly as ``ISORenderer.js:150-165`` (transformed as a *point*, then
normalized — reproduced verbatim).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .. import math3d as m4
from .. import rng, sampling
from . import _march
from .base import Scene, params_dataclass, static_field


@params_dataclass
class Params:
    isovalue: float = 0.5
    light: tuple = (2.0, -3.0, -5.0)
    gradient_step: float = 0.005
    steps: int = static_field(default=50)


def reset(params: Params, height: int, width: int, scene=None):
    """Closest-hit buffer clears to vec4(-1)."""
    return jnp.full((height, width, 4), -1.0, jnp.float32)


def _march_interval_iso(scene, ray_from, direction, params):
    """ISO's marched segment: the cube slab test, clamped to the scene's
    empty-space boxes where that is provably hit-free.

    A hit needs ``TF(volume(p)).a >= isovalue`` (ISORenderer.glsl:68-69):
    - ``occupied_aabb`` (march_clamp) excludes cells with alpha ≡ 0 — no
      hit there for any isovalue > 0;
    - ``iso_aabb`` (iso_clamp_min) excludes cells whose achievable alpha
      stays below the build-time floor — no hit for isovalue ≥ floor.
    The isovalue is a *traced* parameter, so each box engages through a
    ``where`` select on its own validity condition; outside it the exact
    full-segment march runs unchanged."""
    tb = jnp.maximum(sampling.intersect_cube(ray_from, direction), 0.0)

    def clamp_to(box, tb):
        tbb = jnp.maximum(
            sampling.intersect_box(ray_from, direction, box[0], box[1]),
            0.0)
        return jnp.stack([jnp.maximum(tb[..., 0], tbb[..., 0]),
                          jnp.minimum(tb[..., 1], tbb[..., 1])], axis=-1)

    occ = getattr(scene, "occupied_aabb", None)
    if occ is not None:
        tb = jnp.where(params.isovalue > 0.0, clamp_to(occ, tb), tb)
    iso_box = getattr(scene, "iso_aabb", None)
    if iso_box is not None:
        tb = jnp.where(params.isovalue >= scene.iso_clamp_min,
                       clamp_to(iso_box, tb), tb)
    return tb


def generate(scene: Scene, params: Params, seed, height: int, width: int):
    ndc = sampling.pixel_ndc(height, width)
    ray_from, ray_to = sampling.unproject(ndc, scene.mvp_inverse)
    direction = ray_to - ray_from
    tb = _march_interval_iso(scene, ray_from, direction, params)
    miss = tb[..., 0] >= tb[..., 1]

    start = ray_from + tb[..., 0:1] * direction
    end = ray_from + tb[..., 1:2] * direction
    step_size = jnp.float32(1.0 / params.steps)
    _, offset = rng.uniform(rng.pcg(rng.float_bits_to_uint(seed)))

    # backward march: t = 1 - offset*step - i*step (glsl:64-73); the last
    # write wins, which is the nearest hit
    def composite(closest, t, color, valid):
        value = color[..., 3]
        hit = valid & (value >= params.isovalue)
        position = start + t * (end - start)
        candidate = jnp.concatenate(
            [position, jnp.broadcast_to(t, position.shape[:-1])[..., None]],
            axis=-1)
        return jnp.where(hit[..., None], candidate, closest)

    ts = 1.0 - offset * step_size \
        - jnp.arange(params.steps, dtype=jnp.float32) * step_size
    init = jnp.full((height, width, 4), -1.0, jnp.float32)
    closest = _march.march(scene, start, end, ts, composite, init)
    return jnp.where(miss[..., None], -1.0, closest)


def render_frame(state, scene: Scene, params: Params, seed, frame_number):
    """Keep the nearer of (frame, accumulated) hits (integrate:111-121)."""
    height, width = state.shape[:2]
    frame = generate(scene, params, seed, height, width)
    ft, at = frame[..., 3:4], state[..., 3:4]
    both = (ft > 0.0) & (at > 0.0)
    take_frame = jnp.where(both, ft < at, ft > 0.0)
    return jnp.where(take_frame, frame, state)


def display(state, scene: Scene, params: Params):
    """Deferred shade: central-difference normal + Lambert (render:179-191);
    background is white."""
    pos = state[..., :3]
    hit = state[..., 3] > 0.0

    grad = scene.value_gradient(pos, params.gradient_step)
    normal = grad / jnp.sqrt(
        jnp.maximum(jnp.sum(grad * grad, axis=-1, keepdims=True), 1e-12))

    # light: world dir transformed as a point by inv(V·M·center), normalized
    # (ISORenderer.js:157-165)
    inv_mv = m4.invert(scene.model_view)
    light = m4.transform_point(inv_mv, jnp.asarray(params.light, jnp.float32))
    light = light / jnp.sqrt(jnp.maximum(jnp.sum(light * light), 1e-12))

    lambert = jnp.maximum(jnp.sum(normal * light, axis=-1), 0.0)
    material = scene.sample_color(pos)[..., :3]
    shaded = material * lambert[..., None]
    rgb = jnp.where(hit[..., None], shaded, 1.0)
    return jnp.concatenate(
        [rgb, jnp.ones(hit.shape + (1,), jnp.float32)], axis=-1)
