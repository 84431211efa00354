"""Differentiable isosurface rendering: depth + normal gradients.

The reference ISO renderer (``src/glsl/renderers/ISORenderer.glsl:52-76``)
records the nearest sample with ``value ≥ isovalue`` — a hard threshold
whose gradients w.r.t. the voxel grid and the isovalue are zero almost
everywhere.  This module is the AD-friendly re-derivation (BASELINE
config 1: "ISO ... depth + normal gradients"): the binary crossing test
becomes a *soft first-crossing distribution* along each ray,

    a_i = σ((v_i − isovalue) / τ)                (per-step crossing prob)
    w_i = a_i · Π_{j<i} (1 − a_j)                (first crossing at step i)

so expected depth ``t̄ = Σ w_i t_i / Σ w_i`` and the expected hit position
are smooth in the voxel densities, the transfer function, and the
isovalue; normals come from the (already differentiable) central-difference
gradient at the expected hit, and shading mirrors the reference's deferred
Lambert pass (``ISORenderer.glsl:165-191``).  As τ → 0 the estimator
converges to the hard march (asserted in tests/test_diff_iso.py), making it
the inverse-rendering counterpart of ``renderers/iso.py`` in the same way
``diff_mc`` re-derives MCS/MCM.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .. import math3d as m4
from .. import sampling
from .base import Scene, params_dataclass, static_field


@params_dataclass
class Params:
    isovalue: float = 0.5
    light: tuple = (2.0, -3.0, -5.0)
    gradient_step: float = 0.005
    tau: float = 0.02              # crossing softness; ->0 = hard ISO
    steps: int = static_field(default=50)


def render(scene: Scene, params: Params, height: int, width: int) -> dict:
    """One deterministic differentiable pass.

    Returns ``{"depth", "hit", "position", "normal", "image"}``:
    ``depth`` is the expected ray parameter t̄ in [0, 1] over the clipped
    segment (−1 where the ray misses the cube), ``hit`` the soft crossing
    probability Σw, ``position``/``normal`` the expected hit point and its
    unit density gradient, ``image`` the Lambert-shaded RGBA (white
    background, as the reference's display pass)."""
    ndc = sampling.pixel_ndc(height, width)
    ray_from, ray_to = sampling.unproject(ndc, scene.mvp_inverse)
    direction = ray_to - ray_from
    tb = jnp.maximum(sampling.intersect_cube(ray_from, direction), 0.0)
    miss = tb[..., 0] >= tb[..., 1]

    start = ray_from + tb[..., 0:1] * direction
    end = ray_from + tb[..., 1:2] * direction
    step_size = jnp.float32(1.0 / params.steps)

    def step(carry, i):
        transmittance = carry
        t = (i.astype(jnp.float32) + 0.5) * step_size   # front to back
        position = start + t * (end - start)
        value = scene.sample_color(position)[..., 3]
        a = jax.nn.sigmoid((value - params.isovalue) / params.tau)
        w = transmittance * a
        return transmittance * (1.0 - a), (w, w * t)

    _, (ws, wts) = lax.scan(
        step, jnp.ones((height, width), jnp.float32),
        jnp.arange(params.steps))
    hit = jnp.sum(ws, axis=0)                           # Σw  (H, W)
    t_bar = jnp.sum(wts, axis=0) / jnp.maximum(hit, 1e-8)

    position = start + t_bar[..., None] * (end - start)
    grad = scene.value_gradient(position, params.gradient_step)
    normal = grad / jnp.sqrt(
        jnp.maximum(jnp.sum(grad * grad, axis=-1, keepdims=True), 1e-12))

    inv_mv = m4.invert(scene.model_view)
    light = m4.transform_point(inv_mv, jnp.asarray(params.light, jnp.float32))
    light = light / jnp.sqrt(jnp.maximum(jnp.sum(light * light), 1e-12))
    lambert = jnp.maximum(jnp.sum(normal * light, axis=-1), 0.0)
    material = scene.sample_color(position)[..., :3]
    shaded = material * lambert[..., None]
    # soft composite over the white background by hit probability
    rgb = shaded * hit[..., None] + (1.0 - hit[..., None])
    image = jnp.concatenate(
        [rgb, jnp.ones(hit.shape + (1,), jnp.float32)], axis=-1)

    depth = jnp.where(miss, -1.0, t_bar)
    return {
        "depth": depth,
        "hit": jnp.where(miss, 0.0, hit),
        "position": position,
        "normal": normal,
        "image": jnp.where(miss[..., None], jnp.array([1, 1, 1, 1],
                                                      jnp.float32), image),
    }


def depth_loss(volume_leaves, scene_template: Scene, params: Params,
               target_depth, height: int, width: int):
    """Mean-squared depth loss as a function of the voxel grid — the entry
    point for inverse depth fitting (gradients flow to ``volume_leaves``)."""
    import dataclasses as _dc

    sc = _dc.replace(scene_template, volume=volume_leaves,
                     volume_packed=None, transfer_packed=None,
                     transfer_mxu=None)
    out = render(sc, params, height, width)
    valid = target_depth >= 0.0
    err = jnp.where(valid, out["depth"] - target_depth, 0.0)
    return jnp.sum(err * err) / jnp.maximum(jnp.sum(valid), 1.0)
