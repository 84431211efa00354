"""Distributed tests on the virtual 8-device CPU mesh (SURVEY.md §4.4):
N-way sharded renders must equal the single-device render bit for bit, and
sharded-volume gradients must equal replicated gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vpt_jax import transfer, volume
from vpt_jax.parallel import make_mesh, sharded_scene
from vpt_jax.parallel.shard import place_state, shard_display, shard_render_frame
from vpt_jax.renderers import eam, make_scene, mcm

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def scene():
    return make_scene(volume.sphere_volume(16),
                      transfer.gray_ramp(alpha_scale=1.0))


def test_mcm_shard_invariance(scene):
    """Ray/tile data parallelism: identical pixels regardless of sharding."""
    params = mcm.Params(extinction=20.0, steps=8)
    h = w = 32

    # single device
    state1 = mcm.reset(params, h, w, scene)
    state1 = jax.jit(mcm.render_frame)(state1, scene, params,
                                       jnp.float32(0.3), jnp.int32(1))

    # 8-way row sharding
    mesh = make_mesh(8, space=1, axes=("data",))
    sc = sharded_scene(scene, mesh)
    state8 = place_state(mcm.reset(params, h, w, sc), mesh)
    frame_fn = shard_render_frame(mcm, mesh, state8, donate=False)
    state8 = frame_fn(state8, sc, params, jnp.float32(0.3), jnp.int32(1))

    for key in state1:
        a = np.asarray(state1[key])
        b = np.asarray(state8[key])
        assert np.array_equal(a, b), key


def test_mcm_tracking_shard_invariance():
    """The cheb-skip tracking machine under ray sharding: the replicated
    tracking table plus the extra cheb state row-shard like everything
    else, and pixels stay bit-identical to the single-device render."""
    tf = np.asarray(transfer.gray_ramp(alpha_scale=0.8)).copy()
    tf[:, :8, 3] = 0.0                       # exactly-empty TF floor
    sc1 = make_scene(volume.sphere_volume(16), jnp.asarray(tf),
                     tracking="cheb")
    assert sc1.tracking_packed is not None
    params = mcm.Params(extinction=30.0, steps=8)
    h = w = 32

    state1 = mcm.reset(params, h, w, sc1)
    state1 = jax.jit(mcm.render_frame)(state1, sc1, params,
                                       jnp.float32(0.3), jnp.int32(1))

    mesh = make_mesh(8, space=1, axes=("data",))
    sc8 = sharded_scene(sc1, mesh)
    state8 = place_state(mcm.reset(params, h, w, sc8), mesh)
    frame_fn = shard_render_frame(mcm, mesh, state8, donate=False)
    state8 = frame_fn(state8, sc8, params, jnp.float32(0.3), jnp.int32(1))

    assert "cheb" in state1
    for key in state1:
        assert np.array_equal(np.asarray(state1[key]),
                              np.asarray(state8[key])), key


def test_mcm_sharded_display(scene):
    params = mcm.Params(extinction=20.0, steps=4)
    mesh = make_mesh(8, space=1, axes=("data",))
    sc = sharded_scene(scene, mesh)
    state = place_state(mcm.reset(params, 16, 16, sc), mesh)
    disp = shard_display(mcm, mesh, state)
    img = disp(state, sc, params)
    assert img.shape == (16, 16, 4)
    assert np.isfinite(np.asarray(img)).all()


def test_eam_spatial_volume_sharding(scene):
    """Spatial sharding: volume z-sharded over 'space' gives the same image
    as replicated."""
    params = eam.Params(slices=16, random=False)
    h = w = 16

    img_ref = jax.jit(eam.generate, static_argnums=(3, 4))(
        scene, params, jnp.float32(0.0), h, w)

    mesh = make_mesh(8, space=4)
    sc = sharded_scene(scene, mesh, shard_volume=True)
    img_sh = jax.jit(eam.generate, static_argnums=(3, 4))(
        sc, params, jnp.float32(0.0), h, w)
    assert np.allclose(np.asarray(img_ref), np.asarray(img_sh), atol=1e-6)


def test_gradient_allreduce_matches_single_device(scene):
    """psum-accumulated voxel gradients == single-device gradients."""
    params = eam.Params(slices=8, random=False)
    h = w = 16
    vol = scene.volume

    def loss(volume_data, sc):
        sc2 = type(sc)(volume=volume_data, transfer=sc.transfer,
                       environment=sc.environment,
                       mvp_inverse=sc.mvp_inverse, model_view=sc.model_view,
                       projection=sc.projection)
        img = eam.generate(sc2, params, jnp.float32(0.0), h, w)
        return jnp.sum(img[..., :3] ** 2)

    g_ref = jax.jit(jax.grad(loss))(vol, scene)

    mesh = make_mesh(8, space=2)
    sc = sharded_scene(scene, mesh, shard_volume=True)
    g_sh = jax.jit(jax.grad(loss))(sc.volume, sc)
    assert np.allclose(np.asarray(g_ref), np.asarray(g_sh), atol=1e-5)


def test_train_step_on_mesh(scene):
    """One optimization step with dp+sp sharding runs and changes the volume."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vpt_jax.scene import CameraState, default_camera
    from vpt_jax.train import make_train_step

    mesh = make_mesh(8, space=2)
    vol_sh = NamedSharding(mesh, P("space", None, None, None))
    img_sh = NamedSharding(mesh, P("data", None, None))

    cam = CameraState.from_nodes(default_camera())
    mats = (cam.mvp_inverse, cam.model_view, cam.projection)
    vol = jax.device_put(volume.sphere_volume(16).data, vol_sh)
    tf = transfer.gray_ramp(alpha_scale=1.0)
    target = jax.device_put(jnp.zeros((16, 16, 4), jnp.float32), img_sh)

    optimizer = optax.sgd(0.1)
    opt_state = optimizer.init({"volume": vol})
    step = jax.jit(make_train_step(optimizer, params=eam.Params(
        slices=8, random=False), height=16, width=16))
    loss1, vol1, _, opt_state = step(vol, tf, opt_state, mats, target,
                                     jnp.float32(0.0))
    loss2, vol2, _, _ = step(vol1, tf, opt_state, mats, target,
                             jnp.float32(0.0))
    assert float(loss2) < float(loss1)


def test_dryrun_multichip_entrypoint():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_bucketed_gradients_match_monolithic(scene):
    """Per-bucket voxel gradients (the overlappable all-reduce structure)
    must equal the single-tensor gradient exactly."""
    from vpt_jax.parallel.overlap import (
        join_volume, split_volume, value_and_grad_bucketed,
    )

    params = eam.Params(slices=8, random=False)
    h = w = 16

    def loss_of_volume(volume_data):
        sc = type(scene)(volume=volume_data, transfer=scene.transfer,
                         environment=scene.environment,
                         mvp_inverse=scene.mvp_inverse,
                         model_view=scene.model_view,
                         projection=scene.projection)
        img = eam.generate(sc, params, jnp.float32(0.0), h, w)
        return jnp.sum(img[..., :3] ** 2)

    g_ref = jax.grad(loss_of_volume)(scene.volume)

    buckets = split_volume(scene.volume, 4)
    _, g_buckets = jax.jit(
        lambda b: value_and_grad_bucketed(loss_of_volume, b))(buckets)
    # fp reassociation: one scatter-add becomes four -> ~3e-6 relative
    assert np.allclose(np.asarray(join_volume(g_buckets)),
                       np.asarray(g_ref), atol=5e-5)

    # sharded: buckets over data-parallel pixels -> psum per bucket
    mesh = make_mesh(8, space=1, axes=("data",))
    sc_sh = sharded_scene(scene, mesh)
    buckets_sh = split_volume(sc_sh.volume, 4)

    def loss_sh(volume_data):
        sc = type(scene)(volume=volume_data, transfer=sc_sh.transfer,
                         environment=sc_sh.environment,
                         mvp_inverse=sc_sh.mvp_inverse,
                         model_view=sc_sh.model_view,
                         projection=sc_sh.projection)
        img = eam.generate(sc, params, jnp.float32(0.0), h, w)
        return jnp.sum(img[..., :3] ** 2)

    _, g_sh = jax.jit(
        lambda b: value_and_grad_bucketed(loss_sh, b))(buckets_sh)
    assert np.allclose(np.asarray(join_volume(g_sh)), np.asarray(g_ref),
                       atol=1e-5)


def test_bucketed_train_step_decreases_loss(scene):
    import optax

    from vpt_jax.parallel.overlap import bucketed_train_step, split_volume

    params = eam.Params(slices=8, random=False)
    target = jnp.zeros((16, 16, 4), jnp.float32)

    def loss_of_volume(volume_data):
        sc = type(scene)(volume=volume_data, transfer=scene.transfer,
                         environment=scene.environment,
                         mvp_inverse=scene.mvp_inverse,
                         model_view=scene.model_view,
                         projection=scene.projection)
        img = eam.generate(sc, params, jnp.float32(0.0), 16, 16)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    optimizer = optax.sgd(0.5)
    step = jax.jit(bucketed_train_step(optimizer, loss_of_volume, 4))
    vol = scene.volume
    opt_state = optimizer.init(split_volume(vol, 4))
    l1, vol, opt_state = step(vol, opt_state)
    l2, vol, _ = step(vol, opt_state)
    assert float(l2) < float(l1)


def test_dos_halo_sharding_matches_single_device(scene):
    """DOS under row sharding with explicit per-slice occlusion halo
    exchange equals the single-device sweep (the occlusion taps read
    neighboring pixel rows — the one renderer needing a pixel halo)."""
    from vpt_jax.parallel import dos_halo
    from vpt_jax.renderers import dos

    params = dos.Params(extinction=80.0, steps=30, slices=30, samples=4)
    h = w = 64

    state1 = dos.reset(params, h, w, scene)
    state1 = jax.jit(dos.render_frame)(state1, scene, params,
                                       jnp.float32(0.0), jnp.int32(1))

    mesh = make_mesh(8, space=1, axes=("data",))
    sc = sharded_scene(scene, mesh)
    frame_fn, halo = dos_halo.sharded_render_frame(
        mesh, sc, params, h, w, donate=False)
    assert 1 <= halo < h // 8
    state8 = place_state(dos.reset(params, h, w, sc), mesh)
    state8 = frame_fn(state8, sc, params, jnp.float32(0.0), jnp.int32(1))

    for key in state1:
        a, b = np.asarray(state1[key]), np.asarray(state8[key])
        assert np.allclose(a, b, atol=1e-6), key
    # a second frame continues the sweep from carried depth
    state1b = jax.jit(dos.render_frame)(state1, scene, params,
                                        jnp.float32(0.0), jnp.int32(2))
    state8b = frame_fn(state8, sc, params, jnp.float32(0.0), jnp.int32(2))
    assert np.allclose(np.asarray(state1b["color"]),
                       np.asarray(state8b["color"]), atol=1e-6)


def test_dos_halo_offsets_not_sharded_when_samples_equal_height(scene):
    """Regression: the (samples, 2) tap table must replicate even when
    params.samples coincides with the pixel height."""
    from vpt_jax.parallel import dos_halo
    from vpt_jax.renderers import dos

    h = w = 64
    params = dos.Params(extinction=80.0, steps=10, slices=30, samples=h)

    state1 = dos.reset(params, h, w, scene)
    state1 = jax.jit(dos.render_frame)(state1, scene, params,
                                       jnp.float32(0.0), jnp.int32(1))

    mesh = make_mesh(8, space=1, axes=("data",))
    sc = sharded_scene(scene, mesh)
    frame_fn, _ = dos_halo.sharded_render_frame(mesh, sc, params, h, w,
                                                donate=False)
    state8 = place_state(dos.reset(params, h, w, sc), mesh)
    state8 = frame_fn(state8, sc, params, jnp.float32(0.0), jnp.int32(1))
    assert np.allclose(np.asarray(state1["color"]),
                       np.asarray(state8["color"]), atol=1e-6)


def test_dos_halo_rejects_camera_inside_volume(scene):
    """A slice at depth 0 has unbounded tap scale; the builder must refuse
    rather than silently diverge from the single-device sweep."""
    import dataclasses

    from vpt_jax.parallel import dos_halo
    from vpt_jax.renderers import dos
    from vpt_jax.scene import CameraState, default_camera

    inside = CameraState.from_nodes(default_camera(translation=(0, 0, 0.2)))
    sc = dataclasses.replace(scene, mvp_inverse=inside.mvp_inverse,
                             model_view=inside.model_view,
                             projection=inside.projection)
    mesh = make_mesh(8, space=1, axes=("data",))
    with pytest.raises(ValueError, match="unbounded|halo"):
        dos_halo.sharded_render_frame(mesh, sc, dos.Params(), 64, 64)


def test_device_grid_topology_aware():
    """make_mesh groups devices by process so space-rows stay intra-host
    and each host's data rows are contiguous (one crossing between hosts
    per host in hierarchical reductions)."""
    import dataclasses

    from vpt_jax.parallel.mesh import device_grid

    @dataclasses.dataclass(frozen=True)
    class FakeDev:
        process_index: int
        id: int

    # 2 hosts x 4 devices, deliberately interleaved/shuffled input order
    devs = [FakeDev(p, i) for i in range(4) for p in (1, 0)]
    grid = device_grid(devs, space=2)
    assert grid.shape == (4, 2)
    # every space-row lies within a single process
    for row in grid:
        assert len({d.process_index for d in row}) == 1
    # data rows are process-contiguous: host 0 rows first, then host 1
    procs = [row[0].process_index for row in grid]
    assert procs == [0, 0, 1, 1]
    # within a host, device ids are in order
    assert [d.id for d in grid[0]] == [0, 1]
    assert [d.id for d in grid[1]] == [2, 3]

    # non-divisible per-process counts warn but still build
    import warnings

    devs3 = [FakeDev(0, 0), FakeDev(0, 1), FakeDev(0, 2),
             FakeDev(1, 0), FakeDev(1, 1), FakeDev(1, 2)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        grid3 = device_grid(devs3, space=2)
    assert grid3.shape == (3, 2)
    assert any("per-process" in str(x.message) for x in w)
