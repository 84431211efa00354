"""EAM — emission–absorption ray marching with progressive refinement.

Re-implements the reference's EAM renderer (``src/glsl/renderers/
EAMRenderer.glsl`` generate:52-80, integrate:100-119; JS defaults
``EAMRenderer.js:18-45``): front-to-back compositing of the transfer-function
color along each ray with early exit at α > 0.99, and a running-mean
progressive integrate ``mix(acc, frame, 1/frameNumber)``.

Vectorized form: the per-pixel ``while`` march becomes a ``lax.scan`` over
a static ``slices`` trip count with an active mask (no per-pixel
divergence), jitted over the whole (H, W) pixel grid; the ping-pong integrate is
a donated-buffer lerp.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .. import rng, sampling
from . import _march
from .base import Scene, march_interval, params_dataclass, static_field


@params_dataclass
class Params:
    extinction: float = 100.0
    slices: int = static_field(default=64)
    random: bool = static_field(default=True)


def reset(params: Params, height: int, width: int, scene=None):
    """Accumulation clears to (0, 0, 0, 1) (EAM reset fragment)."""
    acc = jnp.zeros((height, width, 4), jnp.float32)
    return acc.at[..., 3].set(1.0)


def generate(scene: Scene, params: Params, seed, height: int, width: int):
    """One stochastic frame: jittered front-to-back march per pixel."""
    ndc = sampling.pixel_ndc(height, width)
    ray_from, ray_to = sampling.unproject(ndc, scene.mvp_inverse)
    direction = ray_to - ray_from
    # occupied-interval clamp when the scene opts in (march_clamp)
    tb = march_interval(scene, ray_from, direction)
    miss = tb[..., 0] >= tb[..., 1]

    start = ray_from + tb[..., 0:1] * direction
    end = ray_from + tb[..., 1:2] * direction
    step_size = jnp.float32(1.0 / params.slices)
    seg_len = jnp.sqrt(jnp.sum((end - start) ** 2, axis=-1))
    ray_step_length = seg_len * step_size

    if params.random:
        # uOffset = Math.random() per frame (EAMRenderer.js:103): one scalar
        # offset for the whole frame, derived deterministically from the seed.
        _, offset = rng.uniform(rng.pcg(rng.float_bits_to_uint(seed)))
    else:
        offset = jnp.float32(0.0)
    t0 = step_size * offset

    def composite(acc, t, color, valid):
        active = valid & (t < 1.0) & (acc[..., 3] < 0.99)
        alpha = color[..., 3] * ray_step_length * params.extinction
        premult = jnp.concatenate(
            [color[..., :3] * alpha[..., None], alpha[..., None]], axis=-1)
        new_acc = acc + (1.0 - acc[..., 3:4]) * premult
        return jnp.where(active[..., None], new_acc, acc)

    ts = t0 + jnp.arange(params.slices, dtype=jnp.float32) * step_size
    acc0 = jnp.zeros((height, width, 4), jnp.float32)
    acc = _march.march(scene, start, end, ts, composite, acc0)

    # `if (a > 1) rgb /= a` over-saturation normalization (EAM glsl:74-76)
    over = acc[..., 3:4] > 1.0
    rgb = jnp.where(over, acc[..., :3] / jnp.maximum(acc[..., 3:4], 1e-6),
                    acc[..., :3])
    frame = jnp.concatenate(
        [rgb, jnp.ones((height, width, 1), jnp.float32)], axis=-1)
    # miss pixels output (0, 0, 0, 1)
    return jnp.where(miss[..., None],
                     jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32), frame)


def render_frame(state, scene: Scene, params: Params, seed, frame_number):
    """generate + integrate: running mean with uMix = 1/frameNumber
    (EAMRenderer.js:120-136; frame 1 replaces the accumulator entirely)."""
    height, width = state.shape[:2]
    frame = generate(scene, params, seed, height, width)
    mix = 1.0 / frame_number.astype(jnp.float32)
    return state + (frame - state) * mix


def display(state, scene: Scene, params: Params):
    return state
