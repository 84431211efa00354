"""MCS — Monte-Carlo single scattering via delta tracking.

Re-implements the reference MCS renderer (``src/glsl/renderers/
MCSRenderer.glsl``): delta-tracking free-path sampling (sampleDistance:70-87),
collision-product transmittance toward a per-frame random light direction
(sampleTransmittance:89-105), environment lookup on miss (:59-62), and
incremental-mean progressive integration (:173-177).  The per-frame uniform
scattering direction replaces the host-side rejection sampling of
``MCSRenderer.js:107-117`` with a seed-derived Marsaglia sphere sample (same
distribution, deterministic).

Vectorized form: the unbounded GLSL ``do/while`` tracking loops become
``lax.while_loop`` over the full pixel grid with per-pixel done masks —
inactive lanes stop consuming RNG draws, so each pixel's uint32 stream
matches a sequential execution exactly.

Scenes built with ``tracking="cheb"``/``"auto"`` extend each free flight
to at least (cheb − 1) empty voxels exactly as in mcm.py (the carried
Chebyshev distance comes from the tracking sampler's own gather; a hop
landing is always TF-empty, so the collision test fails by itself and
the draw-count logic is unchanged) — a different RNG stream, the same
estimator.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .. import rng, sampling
from .base import Scene, params_dataclass

_MAX_TRACKING_ITERS = 100000  # safety backstop; delta tracking terminates
                              # after ~extinction·pathlength expected events


@params_dataclass
class Params:
    extinction: float = 1.0


def reset(params: Params, height: int, width: int, scene=None):
    acc = jnp.zeros((height, width, 4), jnp.float32)
    return acc.at[..., 3].set(1.0)


def generate(scene: Scene, params: Params, seed, height: int, width: int):
    ndc = sampling.pixel_ndc(height, width)
    mapped = ndc * 0.5 + 0.5
    ray_from, ray_to = sampling.unproject(ndc, scene.mvp_inverse)
    direction = ray_to - ray_from
    dir_unit = direction / jnp.sqrt(
        jnp.maximum(jnp.sum(direction ** 2, axis=-1, keepdims=True), 1e-20))
    tb = jnp.maximum(sampling.intersect_cube(ray_from, direction), 0.0)
    miss = tb[..., 0] >= tb[..., 1]

    start = ray_from + tb[..., 0:1] * direction
    end = ray_from + tb[..., 1:2] * direction
    max_distance = jnp.sqrt(jnp.sum((end - start) ** 2, axis=-1))

    use_skip = scene.tracking_packed is not None
    if use_skip:
        # (volume_shape: HaloScene duck-type — it holds only its slab)
        shape3 = getattr(scene, "volume_shape", None)
        dvol, hvol, wvol = (shape3 if shape3 is not None
                            else scene.volume.shape)[:3]
        cell = min(1.0 / dvol, 1.0 / hvol, 1.0 / wvol)

    def alpha_at(pos):
        """(alpha, cheb) at pos — cheb is 0 without a tracking table."""
        if use_skip:
            vs, cheb = scene.sample_color_tracking(pos)
            return vs[..., 3], cheb
        return scene.sample_color(pos)[..., 3], None

    def extend(d, cheb):
        """Free-flight extension through the provably-empty ball around
        the previous landing (cheb-skip; exact by memorylessness)."""
        if not use_skip or cheb is None:
            return d
        return jnp.maximum(d, jnp.maximum(cheb - 1.0, 0.0) * cell)

    # the cheb slot joins the loop carries ONLY in skip mode: a dead carry
    # changes XLA's fusion context and reassociates the exact machine's
    # floats by 1 ulp (observed in the GLSL-emulation comparisons)
    def sample_distance(state, seg_from, seg_to, max_dist):
        """sampleDistance (glsl:70-87): lanes exceeding max_dist consume 1
        draw in their last iteration; colliding/continuing lanes 2."""
        def cond(carry):
            return jnp.any(~carry[2]) & (carry[-1] < _MAX_TRACKING_ITERS)

        def body(carry):
            if use_skip:
                st, dist, done, cheb, it = carry
            else:
                st, dist, done, it = carry
                cheb = None
            s1, d = rng.exponential(st, params.extinction)
            ndist = dist + extend(d, cheb)
            over = ndist > max_dist
            pos = seg_from + (ndist / max_dist)[..., None] * (seg_to - seg_from)
            s2, u = rng.uniform(s1)
            alpha, cheb_new = alpha_at(pos)
            collide = (~over) & (u < alpha)
            st_next = jnp.where(done, st, jnp.where(over, s1, s2))
            dist_next = jnp.where(done, dist, ndist)
            done_next = done | over | collide
            if use_skip:
                cheb = jnp.where(done, cheb, cheb_new)
                return st_next, dist_next, done_next, cheb, it + 1
            return st_next, dist_next, done_next, it + 1

        done0 = jnp.zeros(state.shape, bool)
        dist0 = jnp.zeros(state.shape, jnp.float32)
        carry0 = (state, dist0, done0, dist0, 0) if use_skip \
            else (state, dist0, done0, 0)
        out = lax.while_loop(cond, body, carry0)
        return out[0], out[1]

    def sample_transmittance(state, seg_from, seg_to, max_dist):
        """sampleTransmittance (glsl:89-105): one draw per iteration."""
        def cond(carry):
            return jnp.any(~carry[3]) & (carry[-1] < _MAX_TRACKING_ITERS)

        def body(carry):
            if use_skip:
                st, dist, trans, done, cheb, it = carry
            else:
                st, dist, trans, done, it = carry
                cheb = None
            s1, d = rng.exponential(st, params.extinction)
            ndist = dist + extend(d, cheb)
            over = ndist > max_dist
            pos = seg_from + (ndist / max_dist)[..., None] * (seg_to - seg_from)
            active = (~done) & (~over)
            alpha, cheb_new = alpha_at(pos)
            st_next = jnp.where(done, st, s1)
            dist_next = jnp.where(done, dist, ndist)
            trans_next = jnp.where(active, trans * (1.0 - alpha), trans)
            if use_skip:
                cheb = jnp.where(done, cheb, cheb_new)
                return st_next, dist_next, trans_next, done | over, cheb, \
                    it + 1
            return st_next, dist_next, trans_next, done | over, it + 1

        done0 = jnp.zeros(state.shape, bool)
        dist0 = jnp.zeros(state.shape, jnp.float32)
        trans0 = jnp.ones(state.shape, jnp.float32)
        carry0 = (state, dist0, trans0, done0, dist0, 0) if use_skip \
            else (state, dist0, trans0, done0, 0)
        out = lax.while_loop(cond, body, carry0)
        return out[0], out[2]

    # per-frame scattering direction (uniform sphere, seed-derived)
    dir_state = rng.pcg(rng.float_bits_to_uint(seed) ^ jnp.uint32(0x9E3779B9))
    _, scatter_dir = rng.sphere(dir_state)

    state = rng.seed_pixels(mapped, jnp.asarray(seed, jnp.float32))
    state, dist = sample_distance(state, start, end,
                                  jnp.maximum(max_distance, 1e-20))
    escaped = dist > max_distance

    # scattering point and shadow segment toward the light direction
    t = (dist / jnp.maximum(max_distance, 1e-20))[..., None]
    spoint = start + t * (end - start)
    tb2 = jnp.maximum(sampling.intersect_cube(spoint, scatter_dir), 0.0)
    sto = spoint + scatter_dir * tb2[..., 1:2]
    sdist = jnp.sqrt(jnp.sum((sto - spoint) ** 2, axis=-1))

    diffuse = scene.sample_color_tracking(spoint)[0] if use_skip \
        else scene.sample_color(spoint)
    light = scene.sample_env(scatter_dir)
    state, trans = sample_transmittance(state, spoint, sto,
                                        jnp.maximum(sdist, 1e-20))

    scatter_color = diffuse * light * trans[..., None]
    env_color = scene.sample_env(dir_unit)
    return jnp.where((miss | escaped)[..., None], env_color, scatter_color)


def render_frame(state, scene: Scene, params: Params, seed, frame_number):
    """acc + (frame − acc) / frameNumber (MCS integrate:173-177)."""
    height, width = state.shape[:2]
    frame = generate(scene, params, seed, height, width)
    return state + (frame - state) / frame_number.astype(jnp.float32)


def display(state, scene: Scene, params: Params):
    return state
