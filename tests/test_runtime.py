import numpy as np
import jax
import jax.numpy as jnp

from vpt_jax import transfer, volume
from vpt_jax.runtime import CircleAnimator, OrbitCameraAnimator, RenderingContext
from vpt_jax.scene import default_camera


def make_ctx(renderer="eam", resolution=32):
    ctx = RenderingContext(resolution=resolution)
    ctx.set_volume(volume.sphere_volume(16))
    ctx.set_transfer_function(transfer.gray_ramp(alpha_scale=1.0))
    ctx.choose_renderer(renderer)
    ctx.choose_tone_mapper("reinhard")
    return ctx


def test_context_render_and_display():
    ctx = make_ctx()
    ctx.render(frames=2)
    img = np.asarray(ctx.get_display_image())
    assert img.shape == (32, 32, 4)
    assert np.isfinite(img).all()
    assert ctx.renderer.frame_number == 2


def test_camera_motion_resets_accumulation():
    ctx = make_ctx()
    ctx.render(frames=1)
    assert ctx.renderer.state is not None
    ctx.camera_animator.rotate(0.1, 0.0)
    assert ctx.renderer.state is None  # reset fired via change listener
    ctx.render(frames=1)
    assert ctx.renderer.frame_number >= 1


def test_tf_change_resets():
    ctx = make_ctx()
    ctx.render(frames=1)
    ctx.set_transfer_function(transfer.gray_ramp(alpha_scale=0.5))
    assert ctx.renderer.state is None


def test_checkpoint_roundtrip(tmp_path):
    ctx = make_ctx("eam")
    ctx.render(frames=3)
    img_before = np.asarray(ctx.get_display_image())
    path = tmp_path / "ckpt.npz"
    ctx.save_checkpoint(path)

    ctx2 = make_ctx("eam")
    ctx2.load_checkpoint(path)
    assert ctx2.renderer.frame_number == 3
    img_after = np.asarray(ctx2.get_display_image())
    assert np.allclose(img_before, img_after)


def test_checkpoint_roundtrip_mcm(tmp_path):
    ctx = make_ctx("mcm")
    ctx.render(frames=2)
    path = tmp_path / "mcm.npz"
    ctx.save_checkpoint(path)
    ctx2 = make_ctx("mcm")
    ctx2.load_checkpoint(path)
    a = np.asarray(ctx.get_display_image())
    b = np.asarray(ctx2.get_display_image())
    assert np.allclose(a, b)


def test_record_animation(tmp_path):
    ctx = make_ctx()
    out = ctx.record_animation(tmp_path / "anim", frames=3, spp=1)
    files = sorted(p.name for p in out.iterdir())
    assert files == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]


def test_record_animation_video(tmp_path):
    # MediaRecorder parity (RenderingContext.js:305-352): --video emits a
    # playable file; mp4/webm/avi decode back via OpenCV, gif via PIL.
    import pytest

    cv2 = pytest.importorskip("cv2")
    ctx = make_ctx()
    vid = tmp_path / "anim.mp4"
    ctx.record_animation(tmp_path / "anim", frames=3, spp=1, video=vid,
                         fps=10)
    assert vid.exists() and vid.stat().st_size > 0
    cap = cv2.VideoCapture(str(vid))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 3


def test_write_video_gif_fallback(tmp_path):
    from vpt_jax.io.video import write_video

    frames = [np.full((16, 16, 3), i * 60, np.uint8) for i in range(3)]
    written = write_video(tmp_path / "clip.gif", frames, fps=5)
    assert written.suffix == ".gif" and written.stat().st_size > 0
    # unknown extension degrades to GIF instead of failing
    written = write_video(tmp_path / "clip.xyz", frames, fps=5)
    assert written.suffix == ".gif" and written.exists()


def test_orbit_animator_distance_and_focus():
    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    assert abs(orbit.distance - 2.0) < 1e-5
    orbit.rotate(0.25 * np.pi, 0.0)
    pos = np.asarray(cam.transform.local_translation)
    assert abs(np.linalg.norm(pos) - 2.0) < 1e-4  # stays on the orbit sphere
    orbit.zoom(-1.0)
    assert orbit.distance < 2.0


def test_orbit_camera_looks_at_focus():
    """After any rotation the focus must project to the view center."""
    from vpt_jax import math3d as m4
    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    orbit.rotate(0.3, 0.2)
    view = cam.transform.inverse_global_matrix
    f = m4.transform_point(view, jnp.zeros(3))
    assert abs(float(f[0])) < 1e-4 and abs(float(f[1])) < 1e-4
    assert float(f[2]) < 0  # in front of the camera


def test_circle_animator():
    cam = default_camera()
    circ = CircleAnimator(cam, center=(0, 0, 2), radius=0.5, frequency=1.0)
    circ.update(0.0)
    p0 = np.asarray(cam.transform.local_translation)
    circ.update(0.5)
    p1 = np.asarray(cam.transform.local_translation)
    assert np.allclose(np.linalg.norm(p0 - [0, 0, 2]), 0.5, atol=1e-5)
    assert np.allclose(p0, -(p1 - [0, 0, 2]) + [0, 0, 2], atol=1e-5)


def test_profiler_counts():
    ctx = make_ctx()
    ctx.render(frames=2)
    stats = ctx.profiler.stages["render_frame"]
    assert stats.calls == 2
    assert ctx.profiler.events == 2 * 32 * 32


def test_viewer_server_endpoints():
    from vpt_jax.runtime.viewer import ViewerServer
    import urllib.request

    ctx = make_ctx("mip", resolution=24)
    server = ViewerServer(ctx, port=0)
    port = server.serve_background()
    try:
        base = f"http://127.0.0.1:{port}"
        info = urllib.request.urlopen(f"{base}/info").read()
        assert b"renderers" in info
        page = urllib.request.urlopen(f"{base}/").read()
        assert b"vpt_jax viewer" in page
        png = urllib.request.urlopen(
            f"{base}/frame?yaw=0.3&pitch=0.2&spp=1&renderer=mip"
            f"&tonemap=reinhard&reset=1").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        # progressive continuation accumulates
        png2 = urllib.request.urlopen(
            f"{base}/frame?yaw=0.3&pitch=0.2&spp=1&renderer=mip"
            f"&tonemap=reinhard&reset=0").read()
        assert png2[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        server.shutdown()


def test_viewer_pose_change_keeps_renderer():
    """Camera drags must not rebuild the compiled renderer; traced-param
    changes (GL-uniform class) swap params + reset accumulation without a
    rebuild; static-param changes (shader-recompile class) rebuild."""
    import json as _json

    from vpt_jax.runtime.viewer import ViewerServer

    ctx = make_ctx("eam", resolution=24)
    server = ViewerServer(ctx, port=0)
    q1 = {"yaw": ["0.1"], "pitch": ["0.0"], "renderer": ["eam"],
          "tonemap": ["reinhard"], "rp": [_json.dumps({"extinction": 20})],
          "reset": ["1"]}
    server._apply_query(q1)
    r1 = ctx.renderer
    q2 = dict(q1, yaw=["0.5"], reset=["0"])
    server._apply_query(q2)
    assert ctx.renderer is r1          # pose change: same renderer object
    assert ctx.renderer.state is None  # but accumulation reset
    # traced-param change: same renderer (no recompile), params swapped,
    # accumulation reset (Application.js:130-138 semantics)
    ctx.renderer.state = object()      # sentinel to observe the reset
    q3 = dict(q2, rp=[_json.dumps({"extinction": 55})])
    server._apply_query(q3)
    assert ctx.renderer is r1
    assert float(ctx.renderer.params.extinction) == 55.0
    assert ctx.renderer.state is None
    # static-param change (slices = loop trip count): rebuilt
    q4 = dict(q3, rp=[_json.dumps({"extinction": 55, "slices": 32})])
    server._apply_query(q4)
    assert ctx.renderer is not r1
    assert ctx.renderer.params.slices == 32
    # legacy single-knob clients still work
    q5 = dict(q1, renderer=["mcs"], extinction=["7"])
    del q5["rp"]
    server._apply_query(q5)
    assert float(ctx.renderer.params.extinction) == 7.0
    # malformed rp payloads (valid JSON, wrong shape) fall back to defaults
    for bad in ('[1]', '"x"', '3', 'not-json'):
        server._apply_query(dict(q1, rp=[bad]))


def test_viewer_info_schema_covers_all_params():
    """The /info schema drives the auto-generated panels: every Params
    field of every renderer and every tone-mapper keyword must appear
    (DialogConstructor.js:5-35 parity)."""
    import dataclasses
    import json as _json

    from vpt_jax.renderers import factory
    from vpt_jax.runtime.viewer import ViewerServer
    from vpt_jax.tonemap import TONE_MAPPERS

    ctx = make_ctx("mip", resolution=24)
    info = _json.loads(ViewerServer(ctx, port=0)._info())
    schema = info["schema"]
    for key in factory.MODULES:
        names = {f["name"] for f in schema["renderers"][key]}
        want = {f.name for f in dataclasses.fields(
            factory.get_module(key).Params)}
        assert names == want, key
    for name in TONE_MAPPERS:
        assert name in schema["tonemappers"]
    assert any(f["name"] == "exposure"
               for f in schema["tonemappers"]["reinhard"])


def test_photon_stats_telemetry():
    from vpt_jax import transfer, volume
    from vpt_jax.renderers import make_scene, mcm
    from vpt_jax.runtime.profiler import photon_stats

    scene = make_scene(volume.sphere_volume(16),
                       transfer.gray_ramp(alpha_scale=0.8))
    params = mcm.Params(extinction=30.0, steps=8)
    state = mcm.reset(params, 16, 16, scene)
    for i in range(3):
        state = mcm.render_frame(state, scene, params,
                                 jnp.float32(0.1 * i), jnp.int32(i + 1))
    stats = photon_stats(state)
    assert sum(stats["bounce_histogram"]) == 16 * 16
    assert stats["samples_per_pixel"]["max"] >= \
        stats["samples_per_pixel"]["min"] >= 0.0
    assert 0.0 <= stats["mean_transmittance"]
    assert stats["mean_bounces"] >= 0.0


def test_orbax_sharded_checkpoint_roundtrip(tmp_path):
    """Sharded orbax checkpoint restores bit-identically onto the mesh and
    resumes to the same pixels as the uninterrupted render."""
    import pytest
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from vpt_jax import transfer, volume
    from vpt_jax.parallel import make_mesh, sharded_scene
    from vpt_jax.parallel.shard import place_state, shard_render_frame
    from vpt_jax.renderers import make_scene, mcm
    from vpt_jax.runtime import checkpoint

    scene = make_scene(volume.sphere_volume(16),
                       transfer.gray_ramp(alpha_scale=0.8))
    params = mcm.Params(extinction=20.0, steps=4)
    mesh = make_mesh(8, space=1, axes=("data",))
    sc = sharded_scene(scene, mesh)
    state = place_state(mcm.reset(params, 16, 16, sc), mesh)
    frame_fn = shard_render_frame(mcm, mesh, state, donate=False)
    state = frame_fn(state, sc, params, jnp.float32(0.3), jnp.int32(1))

    checkpoint.save_sharded(tmp_path / "ckpt", "mcm", state, 1,
                            params=params)
    example = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding),
        state)
    key, restored, frame, meta = checkpoint.load_sharded(
        tmp_path / "ckpt", example)
    assert key == "mcm" and frame == 1
    assert meta["params"]["steps"] == 4
    for k in state:
        assert restored[k].sharding == state[k].sharding, k
        assert np.array_equal(np.asarray(restored[k]),
                              np.asarray(state[k])), k

    # resumed frame == uninterrupted frame
    cont = frame_fn(state, sc, params, jnp.float32(0.5), jnp.int32(2))
    res = frame_fn(restored, sc, params, jnp.float32(0.5), jnp.int32(2))
    assert np.array_equal(np.asarray(cont["radiance"]),
                          np.asarray(res["radiance"]))


def test_viewer_tf_editor_endpoints():
    """TF editor round trip: POST widget-JSON bumps -> rasterized texture
    swaps in (and resets accumulation); GET /tf echoes them back; tf.png
    and histogram serve the editor chrome."""
    import json as json_mod
    import urllib.request

    from vpt_jax.runtime.viewer import ViewerServer

    ctx = make_ctx("mip", resolution=24)
    before = np.asarray(ctx.transfer_texture).copy()
    server = ViewerServer(ctx, port=0)
    port = server.serve_background()
    try:
        base = f"http://127.0.0.1:{port}"
        assert json_mod.loads(
            urllib.request.urlopen(f"{base}/tf").read()) == []
        bumps = [{"position": {"x": 0.3, "y": 0.5},
                  "size": {"x": 0.25, "y": 0.2},
                  "color": {"r": 0.2, "g": 0.9, "b": 0.4, "a": 0.8}}]
        req = urllib.request.Request(
            f"{base}/tf", data=json_mod.dumps(bumps).encode(),
            method="POST")
        assert json_mod.loads(urllib.request.urlopen(req).read())["ok"]
        echoed = json_mod.loads(urllib.request.urlopen(f"{base}/tf").read())
        assert len(echoed) == 1
        assert abs(echoed[0]["position"]["x"] - 0.3) < 1e-6
        assert not np.array_equal(before, np.asarray(ctx.transfer_texture))

        png = urllib.request.urlopen(f"{base}/tf.png").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        hist = json_mod.loads(
            urllib.request.urlopen(f"{base}/histogram").read())
        assert len(hist) == 96 and max(hist) == 1.0
    finally:
        server.shutdown()


def test_viewer_resolution_and_filter_controls():
    from vpt_jax.runtime.viewer import ViewerServer

    ctx = make_ctx("mip", resolution=24)
    server = ViewerServer(ctx, port=0)
    q = {"yaw": ["0.1"], "pitch": ["0.0"], "renderer": ["mip"],
         "tonemap": ["reinhard"], "extinction": ["20"],
         "resolution": ["32"], "filter": ["nearest"], "reset": ["1"]}
    server._apply_query(q)
    assert ctx.resolution == 32
    assert ctx.filter == "nearest"
    assert ctx.renderer.height == 32
    img = ctx.render(frames=1) or ctx.get_display_image()
    assert np.asarray(ctx.get_display_image()).shape[0] == 32


def test_viewer_volume_trs_controls():
    from vpt_jax.runtime.viewer import ViewerServer

    ctx = make_ctx("mip", resolution=16)
    server = ViewerServer(ctx, port=0)
    q = {"yaw": ["0.1"], "pitch": ["0.0"], "renderer": ["mip"],
         "tonemap": ["reinhard"], "extinction": ["20"],
         "vtrans": ["0.1,0,0"], "vrot": ["0,45,0"],
         "vscale": ["1,2,1"], "reset": ["1"]}
    server._apply_query(q)
    assert np.allclose(np.asarray(ctx.volume_transform.local_translation),
                       [0.1, 0, 0])
    assert np.allclose(np.asarray(ctx.volume_transform.local_scale),
                       [1, 2, 1])
    before = np.asarray(ctx.get_scene().mvp_inverse).copy()
    # identity TRS restores the default matrices
    q2 = dict(q, vtrans=["0,0,0"], vrot=["0,0,0"], vscale=["1,1,1"])
    server._apply_query(q2)
    after = np.asarray(ctx.get_scene().mvp_inverse)
    assert not np.allclose(before, after)
    ctx.render(frames=1)
    assert np.isfinite(np.asarray(ctx.get_display_image())).all()


def test_viewer_focus_pan_moves_camera():
    from vpt_jax.runtime.viewer import ViewerServer

    ctx = make_ctx("mip", resolution=16)
    server = ViewerServer(ctx, port=0)
    base = {"yaw": ["0.2"], "pitch": ["0.1"], "renderer": ["mip"],
            "tonemap": ["reinhard"], "extinction": ["20"], "reset": ["1"]}
    server._apply_query(dict(base, focus=["0,0,0"]))
    eye0 = np.asarray(ctx.camera.transform.local_translation).copy()
    server._apply_query(dict(base, focus=["0.3,0,0"]))
    eye1 = np.asarray(ctx.camera.transform.local_translation)
    assert np.allclose(eye1 - eye0, [0.3, 0, 0], atol=1e-6)


def test_orbit_animator_fly_and_roll():
    """WASD fly translates the focus along the view basis
    (OrbitCameraAnimator.js:130-160); roll spins the camera about the
    view axis without moving eye or focus."""
    from vpt_jax.runtime.animators import OrbitCameraAnimator
    from vpt_jax.scene import default_camera

    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    focus0 = orbit.focus.copy()
    eye0 = np.asarray(cam.transform.local_translation).copy()

    orbit.fly(forward=0.5)
    right, up, back = orbit._basis()
    moved = orbit.focus - focus0
    # forward = toward the focus = -back
    assert np.allclose(moved, -0.5 * back * orbit.translation_speed,
                       atol=1e-6)
    eye1 = np.asarray(cam.transform.local_translation)
    assert np.allclose(eye1 - eye0, moved, atol=1e-6)  # eye moves with it

    rot_before = np.asarray(cam.transform.local_rotation).copy()
    orbit.roll_by(0.7)
    assert abs(orbit.roll - 0.7) < 1e-9
    assert not np.allclose(np.asarray(cam.transform.local_rotation),
                           rot_before)
    # eye and focus unchanged by roll
    assert np.allclose(np.asarray(cam.transform.local_translation), eye1)
    assert np.allclose(orbit.focus, focus0 + moved)
