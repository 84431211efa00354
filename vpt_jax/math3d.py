"""Small 3D math library (mat4 / quat / vec3) in JAX.

Semantics follow gl-matrix 3.4.1 (the reference's vendored math library,
``/root/reference/src/lib/gl-matrix-module.js``) but matrices here are stored
row-major and applied as ``M @ v`` with ``v`` a column vector — i.e. the same
*mathematical* convention as gl-matrix's column-major ``mat4``; only the
in-memory layout differs.  Everything is float32 and works on host (numpy
inputs) or traced inside jit.
"""

from __future__ import annotations

import jax.numpy as jnp


def vec3(x, y=None, z=None):
    if y is None:
        return jnp.asarray(x, dtype=jnp.float32)
    return jnp.array([x, y, z], dtype=jnp.float32)


def normalize(v, eps=1e-12):
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def cross(a, b):
    return jnp.cross(a, b)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


# ---------------------------------------------------------------------------
# mat4
# ---------------------------------------------------------------------------

def identity():
    return jnp.eye(4, dtype=jnp.float32)


def translation(t):
    """Translation matrix (cf. gl-matrix mat4.fromTranslation)."""
    t = jnp.asarray(t, dtype=jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(t)


def scaling(s):
    s = jnp.asarray(s, dtype=jnp.float32)
    return jnp.diag(jnp.concatenate([s, jnp.ones((1,), jnp.float32)]))


def perspective(fovy, aspect, near, far):
    """OpenGL perspective projection (cf. gl-matrix mat4.perspective).

    Maps view space (camera looking down -z) to clip space with z in [-1, 1].
    """
    f = 1.0 / jnp.tan(jnp.asarray(fovy, jnp.float32) / 2.0)
    nf = 1.0 / (near - far)
    return jnp.array([
        [f / aspect, 0, 0, 0],
        [0, f, 0, 0],
        [0, 0, (far + near) * nf, 2.0 * far * near * nf],
        [0, 0, -1, 0],
    ], dtype=jnp.float32)


def quat_identity():
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=jnp.float32)


def quat_from_axis_angle(axis, angle):
    axis = normalize(jnp.asarray(axis, jnp.float32))
    half = jnp.asarray(angle, jnp.float32) / 2.0
    s = jnp.sin(half)
    return jnp.concatenate([axis * s, jnp.cos(half)[None]])


def quat_multiply(a, b):
    """Hamilton product a*b with (x, y, z, w) storage (gl-matrix order)."""
    ax, ay, az, aw = a[0], a[1], a[2], a[3]
    bx, by, bz, bw = b[0], b[1], b[2], b[3]
    return jnp.stack([
        ax * bw + aw * bx + ay * bz - az * by,
        ay * bw + aw * by + az * bx - ax * bz,
        az * bw + aw * bz + ax * by - ay * bx,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def quat_normalize(q):
    return q / jnp.sqrt(jnp.maximum(jnp.sum(q * q), 1e-20))


def quat_invert(q):
    return jnp.array([-q[0], -q[1], -q[2], q[3]]) / jnp.maximum(jnp.sum(q * q), 1e-20)


def quat_from_euler(x_deg, y_deg, z_deg):
    """gl-matrix quat.fromEuler (degrees, ZYX application order)."""
    d2r = jnp.float32(jnp.pi / 360.0)  # half-angle in radians
    x, y, z = (jnp.asarray(v, jnp.float32) * d2r for v in (x_deg, y_deg, z_deg))
    sx, cx = jnp.sin(x), jnp.cos(x)
    sy, cy = jnp.sin(y), jnp.cos(y)
    sz, cz = jnp.sin(z), jnp.cos(z)
    return jnp.stack([
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz,
    ])


def mat4_from_quat(q):
    x, y, z, w = q[0], q[1], q[2], q[3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return jnp.array([
        [1 - (yy + zz), xy - wz, xz + wy, 0],
        [xy + wz, 1 - (xx + zz), yz - wx, 0],
        [xz - wy, yz + wx, 1 - (xx + yy), 0],
        [0, 0, 0, 1],
    ], dtype=jnp.float32)


def compose_trs(rotation_quat, translation_vec, scale_vec):
    """cf. gl-matrix mat4.fromRotationTranslationScale."""
    r = mat4_from_quat(rotation_quat)
    s = jnp.asarray(scale_vec, jnp.float32)
    m = r.at[:3, :3].multiply(s[None, :])
    return m.at[:3, 3].set(jnp.asarray(translation_vec, jnp.float32))


def matmul(a, b):
    """Small-matrix product at full float32 precision (a float32 matmul on
    the GPU may run in TF32, whose 10-bit mantissa corrupts near/far-plane
    terms in camera math)."""
    import jax

    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def invert(m):
    import jax

    with jax.default_matmul_precision("highest"):
        return jnp.linalg.inv(m).astype(jnp.float32)


def apply_mat4(m, v4):
    """``v4 @ m.T`` as exact elementwise float32 (no matmul — a float32
    matmul on the GPU may run in TF32, which drops small homogeneous
    terms)."""
    return (v4[..., 0:1] * m[:, 0] + v4[..., 1:2] * m[:, 1]
            + v4[..., 2:3] * m[:, 2] + v4[..., 3:4] * m[:, 3])


_apply = apply_mat4


def transform_point(m, p):
    """Apply a mat4 to a 3D point (w = 1) and dehomogenize.

    Supports batched points (..., 3).
    """
    p = jnp.asarray(p, jnp.float32)
    ph = jnp.concatenate([p, jnp.ones(p.shape[:-1] + (1,), jnp.float32)], axis=-1)
    out = _apply(m, ph)
    return out[..., :3] / out[..., 3:4]


def transform_homogeneous(m, p4):
    """Apply a mat4 to a homogeneous 4-vector; supports batch (..., 4)."""
    return _apply(m, jnp.asarray(p4, jnp.float32))


def look_at(eye, center, up):
    """View matrix (cf. gl-matrix mat4.lookAt)."""
    eye = jnp.asarray(eye, jnp.float32)
    f = normalize(jnp.asarray(center, jnp.float32) - eye)
    s = normalize(jnp.cross(f, jnp.asarray(up, jnp.float32)))
    u = jnp.cross(s, f)
    m = jnp.stack([
        jnp.concatenate([s, -jnp.dot(s, eye)[None]]),
        jnp.concatenate([u, -jnp.dot(u, eye)[None]]),
        jnp.concatenate([-f, jnp.dot(f, eye)[None]]),
        jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
    ])
    return m
