import jax.numpy as jnp
import numpy as np

from vpt_jax import math3d as m4
from vpt_jax import scene


def test_perspective_matches_gl():
    # gl-matrix mat4.perspective(1, 1, 0.1, 100): f = 1/tan(0.5)
    p = np.asarray(m4.perspective(1.0, 1.0, 0.1, 100.0))
    f = 1.0 / np.tan(0.5)
    assert np.allclose(p[0, 0], f, rtol=1e-6)
    assert np.allclose(p[1, 1], f, rtol=1e-6)
    assert np.allclose(p[2, 2], (100.0 + 0.1) / (0.1 - 100.0), rtol=1e-6)
    assert np.allclose(p[2, 3], 2 * 100.0 * 0.1 / (0.1 - 100.0), rtol=1e-6)
    assert p[3, 2] == -1.0


def test_perspective_projects_points():
    p = m4.perspective(np.pi / 2, 1.0, 1.0, 10.0)
    # point on the near plane center maps to z = -1
    out = m4.transform_point(p, jnp.array([0.0, 0.0, -1.0]))
    assert np.allclose(np.asarray(out), [0, 0, -1], atol=1e-6)
    # point on the far plane maps to z = +1
    out = m4.transform_point(p, jnp.array([0.0, 0.0, -10.0]))
    assert np.allclose(np.asarray(out), [0, 0, 1], atol=1e-5)


def test_quat_roundtrip():
    q = m4.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.7)
    r = m4.mat4_from_quat(q)
    v = jnp.array([1.0, 0.0, 0.0])
    out = np.asarray(m4.transform_point(r, v))
    expected = [np.cos(0.7), 0.0, -np.sin(0.7)]
    assert np.allclose(out, expected, atol=1e-6)


def test_quat_multiply_composes():
    qa = m4.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), 0.3)
    qb = m4.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), 0.5)
    qc = m4.quat_multiply(qa, qb)
    expected = m4.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), 0.8)
    assert np.allclose(np.asarray(qc), np.asarray(expected), atol=1e-6)


def test_compose_trs_order():
    # TRS: scale, then rotate, then translate
    q = m4.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), np.pi / 2)
    m = m4.compose_trs(q, jnp.array([1.0, 2.0, 3.0]), jnp.array([2.0, 2.0, 2.0]))
    out = np.asarray(m4.transform_point(m, jnp.array([1.0, 0.0, 0.0])))
    assert np.allclose(out, [1.0, 4.0, 3.0], atol=1e-5)


def test_transform_parent_chain():
    root = scene.Node()
    child = scene.Node()
    root.add_child(child)
    root.transform.local_translation = [1.0, 0.0, 0.0]
    child.transform.local_translation = [0.0, 1.0, 0.0]
    g = np.asarray(child.transform.global_matrix)
    assert np.allclose(g[:3, 3], [1.0, 1.0, 0.0])
    inv = np.asarray(child.transform.inverse_global_matrix)
    assert np.allclose(inv @ g, np.eye(4), atol=1e-6)


def test_transform_change_listener_fires():
    t = scene.Transform()
    calls = []
    t.add_change_listener(lambda: calls.append(1))
    t.local_translation = [0.0, 0.0, 5.0]
    t.local_rotation = m4.quat_identity()
    assert len(calls) == 2


def test_mvp_inverse_unprojects_camera_center():
    cam = scene.default_camera()
    inv = np.asarray(scene.mvp_inverse(cam))
    # NDC origin on the near plane should land on the view ray through the
    # camera: camera at (0,0,2) world, volume centered at origin via the
    # center(-0.5) matrix => texture-space camera position (0.5, 0.5, 2.5).
    near = inv @ np.array([0.0, 0.0, -1.0, 1.0])
    far = inv @ np.array([0.0, 0.0, 1.0, 1.0])
    near = near[:3] / near[3]
    far = far[:3] / far[3]
    direction = far - near
    direction /= np.linalg.norm(direction)
    assert np.allclose(direction, [0.0, 0.0, -1.0], atol=1e-5)
    assert np.allclose(near[:2], [0.5, 0.5], atol=1e-5)
    assert np.allclose(near[2], 2.5 - 0.1, atol=1e-4)


def test_camera_state_pytree_shapes():
    cam = scene.default_camera()
    st = scene.CameraState.from_nodes(cam)
    assert st.mvp_inverse.shape == (4, 4)
    assert st.model_view.shape == (4, 4)
    assert st.projection.shape == (4, 4)


def test_look_at():
    m = np.asarray(m4.look_at(jnp.array([0.0, 0.0, 5.0]),
                              jnp.zeros(3), jnp.array([0.0, 1.0, 0.0])))
    out = m @ np.array([0.0, 0.0, 0.0, 1.0])
    assert np.allclose(out[:3], [0.0, 0.0, -5.0], atol=1e-6)
