"""Counter/hash-based RNG reproducing the reference's GLSL random library.

Re-implements, bit-for-bit where possible, the hash functions and sampling
distributions of ``/root/reference/src/glsl/mixins/random/`` (7 scalar hashes,
3 vector "squash" combiners, and the distribution set used by the MC
renderers: uniform, square, circle, disk, sphere, hemisphere, ball, normal,
exponential).  The per-pixel RNG state is an explicit uint32 array threaded
functionally through the kernels, so renders are deterministic under jit,
resharding, and checkpoint/resume.

All functions are elementwise integer ops over arbitrarily shaped uint32
state arrays; nothing here touches jax.random — the MCM /
MCS renderers need the *exact* GLSL stream semantics (hash-chained state,
float(state)/float(~0u) uniforms) to match the reference's output
(``MCMRenderer.glsl:128-144``).
"""

from __future__ import annotations

import numpy as _np
import jax.numpy as jnp
from jax import lax

_np_f32 = _np.float32
_U32 = jnp.uint32
_F32 = jnp.float32

TWOPI = _np_f32(6.28318530718)
# float(~0u) rounded to float32, matching GLSL's float(4294967295u).
_INV_MAX = _np_f32(4294967295.0)


def u32(x):
    return jnp.asarray(x, dtype=_U32)


def float_bits_to_uint(x):
    """GLSL floatBitsToUint — reinterpret float32 bits as uint32."""
    return lax.bitcast_convert_type(jnp.asarray(x, _F32), _U32)


def uint_bits_to_float(x):
    return lax.bitcast_convert_type(jnp.asarray(x, _U32), _F32)


# ---------------------------------------------------------------------------
# Scalar hashes (cf. src/glsl/mixins/random/hash/*.glsl)
# ---------------------------------------------------------------------------

def pcg(x):
    """PCG output permutation (random/hash/pcg.glsl:3-8) — the hash used by
    the MCM/MCS renderers."""
    x = u32(x)
    x = x * u32(747796405) + u32(2891336453)
    x = ((x >> ((x >> u32(28)) + u32(4))) ^ x) * u32(277803737)
    return (x >> u32(22)) ^ x


def lcg(x):
    x = u32(x)
    return x * u32(1664525) + u32(1013904223)


def wang(x):
    x = u32(x)
    x = (x ^ u32(61)) ^ (x >> u32(16))
    x = x * u32(9)
    x = x ^ (x >> u32(4))
    x = x * u32(0x27D4EB2D)
    return x ^ (x >> u32(15))


def jenkins(x):
    x = u32(x)
    x = x + (x << u32(10))
    x = x ^ (x >> u32(6))
    x = x + (x << u32(3))
    x = x ^ (x >> u32(11))
    x = x + (x << u32(15))
    return x


def xorshift(x):
    x = u32(x)
    x = x ^ (x << u32(13))
    x = x ^ (x >> u32(17))
    x = x ^ (x << u32(5))
    return x


def xxhash(x):
    x = u32(x)
    x = x + u32(374761393)
    x = u32(668265263) * ((x << u32(17)) | (x >> u32(15)))
    x = u32(2246822519) * (x ^ (x >> u32(15)))
    x = u32(3266489917) * (x ^ (x >> u32(13)))
    return x ^ (x >> u32(16))


def bbs(x):
    x = u32(x) % u32(65521)
    x = (x * x) % u32(65521)
    x = (x * x) % u32(65521)
    return x


# ---------------------------------------------------------------------------
# Vector squashers (cf. random/hash/squash*.glsl)
# ---------------------------------------------------------------------------

def squash_linear(parts, hash_fn=pcg):
    """hash(uvecN) of squashlinear.glsl — the MCM seeding combiner."""
    parts = [u32(p) for p in parts]
    if len(parts) == 2:
        acc = u32(19) * parts[0] + u32(47) * parts[1] + u32(101)
    elif len(parts) == 3:
        acc = (u32(19) * parts[0] + u32(47) * parts[1]
               + u32(101) * parts[2] + u32(131))
    elif len(parts) == 4:
        acc = (u32(19) * parts[0] + u32(47) * parts[1] + u32(101) * parts[2]
               + u32(131) * parts[3] + u32(173))
    else:
        raise ValueError("squash_linear takes 2-4 parts")
    return hash_fn(acc)


def squash_nested(parts, hash_fn=pcg):
    acc = hash_fn(u32(parts[0]))
    for p in parts[1:]:
        acc = hash_fn(acc + u32(p))
    return acc


def squash_xor(parts, hash_fn=pcg):
    acc = u32(parts[0])
    for p in parts[1:]:
        acc = acc ^ hash_fn(u32(p))
    return hash_fn(acc)


def seed_pixels(ndc_xy, rand_seed, hash_fn=pcg):
    """Per-pixel stream seeding exactly as MCMRenderer.glsl:128 /
    MCSRenderer.glsl:121: hash(uvec3(floatBitsToUint(pos.xy),
    floatBitsToUint(seed))).

    ``ndc_xy``: (..., 2) float32 positions; ``rand_seed``: float32 scalar.
    Returns a (...,) uint32 state array.
    """
    px = float_bits_to_uint(ndc_xy[..., 0])
    py = float_bits_to_uint(ndc_xy[..., 1])
    ps = jnp.broadcast_to(float_bits_to_uint(rand_seed), px.shape)
    return squash_linear([px, py, ps], hash_fn=hash_fn)


# ---------------------------------------------------------------------------
# Distributions (cf. random/distribution/*.glsl) — functional `inout state`
# ---------------------------------------------------------------------------

def uniform(state, hash_fn=pcg):
    """uniformdivision.glsl: state = hash(state); u = float(state)/float(~0u)."""
    state = hash_fn(state)
    return state, state.astype(_F32) / _INV_MAX


def uniform_cast(state, hash_fn=pcg):
    """uniformcast.glsl bit-cast variant."""
    state = hash_fn(state)
    bits = (state & u32(0x007FFFFF)) | u32(0x3F800000)
    return state, uint_bits_to_float(bits) - _F32(1.0)


def square(state):
    state, x = uniform(state)
    state, y = uniform(state)
    return state, jnp.stack([x, y], axis=-1)


def circle(state):
    state, a = uniform(state)
    angle = TWOPI * a
    return state, jnp.stack([jnp.cos(angle), jnp.sin(angle)], axis=-1)


def disk(state):
    state, r = uniform(state)
    state, a = uniform(state)
    radius = jnp.sqrt(r)
    angle = TWOPI * a
    return state, radius[..., None] * jnp.stack(
        [jnp.cos(angle), jnp.sin(angle)], axis=-1)


def sphere(state):
    """Marsaglia (1972) via disk — matches sphere.glsl exactly (same draws)."""
    state, d = disk(state)
    norm = jnp.sum(d * d, axis=-1)
    radius = 2.0 * jnp.sqrt(jnp.maximum(1.0 - norm, 0.0))
    z = 1.0 - 2.0 * norm
    return state, jnp.concatenate(
        [radius[..., None] * d, z[..., None]], axis=-1)


def hemisphere(state):
    state, z = uniform(state)
    state, a = uniform(state)
    radius = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    angle = TWOPI * a
    return state, jnp.stack(
        [radius * jnp.cos(angle), radius * jnp.sin(angle), z], axis=-1)


def ball(state):
    state, uz = uniform(state)
    state, ua = uniform(state)
    state, ur = uniform(state)
    z = 1.0 - 2.0 * uz
    angle = TWOPI * ua
    radius = jnp.cbrt(ur)
    height = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return state, radius[..., None] * jnp.stack(
        [height * jnp.cos(angle), height * jnp.sin(angle), z], axis=-1)


def normal(state):
    """Box-Muller (1958), cosine branch only — matches normal.glsl."""
    state, r = uniform(state)
    state, a = uniform(state)
    radius = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(r, jnp.float32(1e-38))))
    return state, radius * jnp.cos(TWOPI * a)


def exponential(state, rate):
    """exponential.glsl: -log(u)/rate.  u is clamped away from 0 to keep the
    free-path finite (probability 2^-32 deviation from the GLSL, which would
    produce +inf and NaN positions)."""
    state, x = uniform(state)
    x = jnp.maximum(x, jnp.float32(1e-38))
    return state, -jnp.log(x) / rate


# Legacy trig hash used only by the LAO renderer (mixins/rand.glsl:3-14).
def rand_vec2(p):
    m = jnp.array([[23.14069263277926, 12.98987893203892],
                   [2.665144142690225, 78.23376739376591]], dtype=_F32)
    d = jnp.array([1235.6789, 4378.5453], dtype=_F32)
    pp = jnp.asarray(p, _F32)
    dotted = pp[..., 0:1] * m[:, 0] + pp[..., 1:2] * m[:, 1]
    mapped = jnp.stack([jnp.cos(dotted[..., 0]), jnp.sin(dotted[..., 1])],
                       axis=-1)
    return jnp.mod(mapped * d, 1.0)


# 4-lane LCG float RNG (mixins/btrand.glsl:3-17, unused by current renderers
# but part of the shader stdlib surface).
def btrand(n):
    q = jnp.array([1225.0, 1585.0, 2457.0, 2098.0], dtype=_F32)
    r = jnp.array([1112.0, 367.0, 92.0, 265.0], dtype=_F32)
    a = jnp.array([3423.0, 2646.0, 1707.0, 1999.0], dtype=_F32)
    m = jnp.array([4194287.0, 4194277.0, 4194191.0, 4194167.0], dtype=_F32)
    n = jnp.asarray(n, _F32)
    beta = jnp.floor(n / q)
    p = a * (n - beta * q) - beta * r
    beta = (jnp.sign(-p) + 1.0) * 0.5 * m
    n = p + beta
    value = jnp.mod(jnp.sum(n / m * jnp.array([1.0, -1.0, 1.0, -1.0], _F32),
                            axis=-1), 1.0)
    return n, value
