"""Halo-sharded volume rendering must match the replicated render exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vpt_jax import transfer, volume
from vpt_jax.parallel import make_mesh
from vpt_jax.parallel.halo import (
    HaloScene, shard_volume_with_halo, sharded_render_frame,
)
from vpt_jax.parallel.shard import place_state
from vpt_jax.renderers import eam, make_scene, mcm

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module", params=[False, True],
                ids=["unpacked", "corner-packed"])
def scene(request):
    return make_scene(volume.blobs_volume(16, seed=5),
                      transfer.gray_ramp(alpha_scale=1.0),
                      pack=request.param)


def test_shard_volume_with_halo_layout(scene):
    slabs = shard_volume_with_halo(scene.volume, 4)
    assert slabs.shape == (4, 5, 16, 16, 1)
    v = np.asarray(scene.volume)
    s = np.asarray(slabs)
    for k in range(4):
        assert np.array_equal(s[k, :4], v[4 * k:4 * k + 4])
    # halo plane = next slab's first plane; last slab replicates its edge
    assert np.array_equal(s[0, 4], v[4])
    assert np.array_equal(s[3, 4], v[15])


def test_halo_eam_matches_replicated(scene):
    mesh = make_mesh(8, space=2)
    params = eam.Params(slices=16, random=False)
    h = w = 16

    ref = np.asarray(jax.jit(eam.generate, static_argnums=(3, 4))(
        scene, params, jnp.float32(0.0), h, w))

    state = place_state(eam.reset(params, h, w), mesh)
    frame_fn, slabs = sharded_render_frame(eam, mesh, scene, 2, state)
    out = frame_fn(state, slabs, params, jnp.float32(0.0), jnp.int32(1))
    assert np.array_equal(np.asarray(out), ref)  # frame 1 == generate


def test_halo_mcm_matches_replicated(scene):
    mesh = make_mesh(8, space=4)
    params = mcm.Params(extinction=25.0, steps=8)
    h = w = 16

    s0 = mcm.reset(params, h, w, scene)
    ref = mcm.render_frame(s0, scene, params, jnp.float32(0.7), jnp.int32(1))

    state = place_state(mcm.reset(params, h, w, scene), mesh)
    frame_fn, slabs = sharded_render_frame(mcm, mesh, scene, 4, state)
    out = frame_fn(state, slabs, params, jnp.float32(0.7), jnp.int32(1))
    for k in ref:
        if k == "position":
            # 1-ulp fp reassociation under the shard_map partitioner
            assert np.allclose(np.asarray(ref[k]), np.asarray(out[k]),
                               atol=2e-7), k
        else:
            assert np.array_equal(np.asarray(ref[k]), np.asarray(out[k])), k


def test_halo_scene_sampler_matches_dense(scene):
    """Single-process check of the ownership-masked trilinear math itself
    (no mesh): emulate the psum by summing each slab's contribution."""
    from vpt_jax import sampling

    num_slabs = 4
    slabs = shard_volume_with_halo(scene.volume, num_slabs)
    rng_np = np.random.default_rng(0)
    p = jnp.asarray(rng_np.uniform(-0.1, 1.1, (2000, 3)).astype(np.float32))

    total = jnp.zeros((2000, 1), jnp.float32)
    for k in range(num_slabs):
        hs = HaloScene.__new__(HaloScene)
        hs.slab = slabs[k]
        hs.slab_index = jnp.int32(k)
        hs.num_slabs = num_slabs
        hs.volume_shape = scene.volume.shape
        hs.axis = None
        hs.slab_packed = None

        # monkeypatch psum away for the single-process check
        d, h, w, c = hs.volume_shape
        ds = d // num_slabs
        dims = jnp.array([w, h, d], jnp.float32)
        u = jnp.clip(p * dims - 0.5, 0.0, dims - 1.0)
        i0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0,
                      jnp.array([w - 1, h - 1, d - 1], jnp.int32))
        owner = jnp.clip(i0[..., 2] // ds, 0, num_slabs - 1)
        import vpt_jax.parallel.halo as halo_mod
        orig = halo_mod.lax.psum
        halo_mod.lax.psum = lambda x, axis: x
        try:
            contrib = hs._sample(p)
        finally:
            halo_mod.lax.psum = orig
        total = total + contrib

    dense = sampling.sample_volume(scene.volume, p)
    assert np.allclose(np.asarray(total), np.asarray(dense), atol=1e-6)


@pytest.mark.parametrize("key", ["mip", "iso", "depth"])
def test_halo_march_renderers_match(scene, key):
    from vpt_jax.renderers import factory

    module = factory.get_module(key)
    mesh = make_mesh(8, space=2)
    params = module.Params()
    h = w = 16
    s0 = module.reset(params, h, w, scene)
    ref = module.render_frame(s0, scene, params, jnp.float32(0.3),
                              jnp.int32(1))
    state = place_state(module.reset(params, h, w, scene), mesh)
    frame_fn, slabs = sharded_render_frame(module, mesh, scene, 2, state)
    out = frame_fn(state, slabs, params, jnp.float32(0.3), jnp.int32(1))
    assert np.allclose(np.asarray(ref), np.asarray(out), atol=2e-6)


@pytest.mark.parametrize("tf_mxu", [False, True], ids=["tf-gather",
                                                       "tf-mxu"])
def test_halo_mcm_tracking_matches_replicated(tf_mxu):
    """Cheb-skip under spatial sharding: the slab tracking tables are row
    slices of the global table (chebdist is a global property), and the
    sharded tracking machine must reproduce the replicated one bit for
    bit — same hops, same draws, same deposits.  Covers both TF lookup
    paths: the sharded sampler must take the same one as the replicated
    Scene (a different path would quantize alpha differently and flip
    discrete branches)."""
    tf = np.asarray(transfer.gray_ramp(alpha_scale=0.8)).copy()
    tf[:, :8, 3] = 0.0                       # exactly-empty TF floor
    sc = make_scene(volume.blobs_volume(16, seed=5), jnp.asarray(tf),
                    tracking="cheb", tf_mxu=tf_mxu)
    assert sc.tracking_packed is not None
    mesh = make_mesh(8, space=4)
    params = mcm.Params(extinction=30.0, steps=8)
    h = w = 16

    s0 = mcm.reset(params, h, w, sc)
    assert "cheb" in s0
    ref = mcm.render_frame(s0, sc, params, jnp.float32(0.7), jnp.int32(1))
    ref = mcm.render_frame(ref, sc, params, jnp.float32(0.9), jnp.int32(2))

    state = place_state(mcm.reset(params, h, w, sc), mesh)
    frame_fn, slabs = sharded_render_frame(mcm, mesh, sc, 4, state)
    out = frame_fn(state, slabs, params, jnp.float32(0.7), jnp.int32(1))
    out = frame_fn(out, slabs, params, jnp.float32(0.9), jnp.int32(2))

    for key in ref:
        a, b = np.asarray(ref[key]), np.asarray(out[key])
        if key == "position":
            # 1-ulp committed-position drift: measured to appear already at
            # the FIRST event with cheb == 0 everywhere (no hop taken), i.e.
            # it is the shard_map partitioner's codegen of the flight/reset
            # FMA — the same caveat as the non-tracking test above, NOT the
            # hop math (cheb itself, recovered via jnp.round, is asserted
            # bitwise below, so hop distances are identical)
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-7)
        else:
            assert np.array_equal(a, b), key
    # the skip actually engaged (some photons carry nonzero cheb)
    assert float(np.asarray(out["cheb"]).max()) > 0
