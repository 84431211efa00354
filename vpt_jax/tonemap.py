"""Tone-mapping suite: the reference's ten curves as pure, differentiable ops.

Parity with ``src/js/tonemappers/`` + ``src/glsl/tonemappers/`` (registry
``ToneMapperFactory.js:12-27``).  Every mapper maps an (..., 3|4) HDR image to
display RGB; all but Artistic/Range expose ``exposure`` and ``gamma`` with the
reference defaults (1.0, 2.2).  Each curve matches its GLSL fragment shader:

- artistic  — ArtisticToneMapper.glsl (low/mid/high levels + saturation)
- range     — RangeToneMapper.glsl (linear window + gamma)
- reinhard  — x/(1+x)
- reinhard2 — extended Reinhard, L_white = 4
- uncharted2 — Hable filmic with white scale
- filmic    — Hejl–Burgess-Dawson (gamma folded into the fit)
- unreal    — x/(x+0.155)·1.019
- aces      — Narkowicz ACES fit
- lottes    — AMD curve with derived b, c
- uchimura  — Gran Turismo curve (P, a, m, l, c, b)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import jax.numpy as jnp

from .utils import smoothstep as _smoothstep


def _split_rgb(image):
    if image.shape[-1] == 4:
        return image[..., :3]
    return image


def _finish(rgb, gamma):
    """pow(vec4(curve(rgb*exposure), 1), 1/gamma) as in every GLSL mapper."""
    rgb = jnp.power(jnp.maximum(rgb, 0.0), 1.0 / gamma)
    return jnp.concatenate([rgb, jnp.ones(rgb.shape[:-1] + (1,),
                                          rgb.dtype)], axis=-1)


# Raw per-channel curves (pre-gamma) of the mappers below.

def _curve_reinhard(x):
    return x / (1.0 + x)


def _curve_reinhard2(x):
    l_white2 = 4.0 * 4.0
    return (x * (1.0 + x / l_white2)) / (1.0 + x)


def _curve_uncharted2(x):
    w = 11.2
    curr = _uncharted2_curve(2.0 * x)
    return curr / _uncharted2_curve(jnp.float32(w))


def _curve_filmic(x):
    x = jnp.maximum(0.0, x - 0.004)
    result = (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    return jnp.power(result, 2.2)


def _curve_unreal(x):
    return x / (x + 0.155) * 1.019


def _curve_aces(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _curve_lottes(x):
    x = jnp.maximum(x, 0.0)
    a, d, hdr_max, mid_in, mid_out = 1.6, 0.977, 8.0, 0.18, 0.267
    b = ((-mid_in ** a + hdr_max ** a * mid_out)
         / ((hdr_max ** (a * d) - mid_in ** (a * d)) * mid_out))
    c = ((hdr_max ** (a * d) * mid_in ** a
          - hdr_max ** a * mid_in ** (a * d) * mid_out)
         / ((hdr_max ** (a * d) - mid_in ** (a * d)) * mid_out))
    return jnp.power(x, a) / (jnp.power(x, a * d) * b + c)


def _curve_uchimura(x):
    x = jnp.maximum(x, 0.0)
    p, a, m, l, c, b = 1.0, 1.0, 0.22, 0.4, 1.33, 0.0
    l0 = ((p - m) * l) / a
    s0 = m + l0
    s1 = m + a * l0
    c2 = (a * p) / (p - s1)
    cp = -c2 / p
    w0 = 1.0 - _smoothstep(0.0, m, x)
    w2 = jnp.where(x >= m + l0, 1.0, 0.0)
    w1 = 1.0 - w0 - w2
    t = m * jnp.power(x / m, c) + b
    s = p - (p - s1) * jnp.exp(cp * (x - s0))
    lin = m + a * (x - m)
    return t * w0 + lin * w1 + s * w2


def reinhard(image, exposure=1.0, gamma=2.2):
    x = _split_rgb(image) * exposure
    return _finish(_curve_reinhard(x), gamma)


def reinhard2(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_reinhard2(_split_rgb(image) * exposure), gamma)


def _uncharted2_curve(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_uncharted2(_split_rgb(image) * exposure), gamma)


def filmic(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_filmic(_split_rgb(image) * exposure), gamma)


def unreal(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_unreal(_split_rgb(image) * exposure), gamma)


def aces(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_aces(_split_rgb(image) * exposure), gamma)


def lottes(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_lottes(_split_rgb(image) * exposure), gamma)


def uchimura(image, exposure=1.0, gamma=2.2):
    return _finish(_curve_uchimura(_split_rgb(image) * exposure), gamma)


def range_map(image, low=0.0, high=1.0, gamma=2.2):
    """RangeToneMapper.glsl: linear window [min, max] + gamma (applied to all
    four channels in the shader; here to RGB)."""
    x = _split_rgb(image)
    return _finish((x - low) / (high - low), gamma)


def artistic(image, low=0.0, mid=0.5, high=1.0, saturation=1.0, gamma=2.2):
    """ArtisticToneMapper.glsl: levels + saturation + implied gamma exponent."""
    x = (_split_rgb(image) - low) / (high - low)
    gray = jnp.full((3,), 1.0 / jnp.sqrt(3.0), jnp.float32)
    luma = jnp.sum(x * gray, axis=-1, keepdims=True) * gray
    x = luma * (1.0 - saturation) + x * saturation
    midpoint = (mid - low) / (high - low)
    exponent = -jnp.log(midpoint) / jnp.log(2.0)
    rgb = jnp.power(jnp.maximum(x, 0.0), exponent / gamma)
    return jnp.concatenate([rgb, jnp.ones(rgb.shape[:-1] + (1,),
                                          rgb.dtype)], axis=-1)


TONE_MAPPERS: Dict[str, Callable] = {
    "artistic": artistic,
    "range": range_map,
    "reinhard": reinhard,
    "reinhard2": reinhard2,
    "uncharted2": uncharted2,
    "filmic": filmic,
    "unreal": unreal,
    "aces": aces,
    "lottes": lottes,
    "uchimura": uchimura,
}


@dataclasses.dataclass
class ToneMapper:
    """Configured tone mapper (ToneMapperFactory parity); callable on images."""

    name: str = "artistic"
    params: dict = dataclasses.field(default_factory=dict)

    def __call__(self, image):
        return TONE_MAPPERS[self.name](image, **self.params)


def get(name: str) -> Callable:
    if name not in TONE_MAPPERS:
        raise ValueError(
            f"unknown tone mapper {name!r}; available: {sorted(TONE_MAPPERS)}")
    return TONE_MAPPERS[name]
