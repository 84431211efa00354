"""Differentiable spatially sharded rendering (BASELINE config 4).

Oracle strategy: the exact-equality check runs through EAM, whose
halo-sharded forward is bit-identical to the replicated render
(test_halo.py) — so its voxel gradient must match the replicated gradient
up to backward-pass reassociation.  MCM's sharded forward can flip
discrete branches on 1-ulp partitioner reassociation (documented in
halo.py), so per-seed gradient equality vs the replicated run is not a
valid oracle there; instead MCM is pinned by (a) bucket-count invariance
(bucketing is an exact restructuring of the same program) and (b) the
forward bit-identity already asserted in test_halo.py — the gradient
plumbing (halo exchange, psum transpose) is shared with the EAM case.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vpt_jax import sampling, transfer, volume
from vpt_jax.parallel import make_mesh
from vpt_jax.parallel.halo import shard_volume_with_halo
from vpt_jax.parallel.halo_grad import make_sharded_grad, place_slabs, rehalo
from vpt_jax.renderers import diff_mc, eam, make_scene, mcm

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

NUM_SLABS = 4
H = W = 12
FRAMES = 3


def eam_expected(scene, params, height, width, frames, seed0=0.0,
                 score_floor=None):
    return eam.generate(scene, params, jnp.float32(seed0), height, width)


@pytest.fixture(scope="module")
def setup():
    scene = make_scene(volume.blobs_volume(16, seed=5),
                       transfer.gray_ramp(alpha_scale=1.0), pack=False)
    target = jnp.full((H, W, 3), 0.4, jnp.float32)
    return scene, target


@pytest.mark.parametrize("num_buckets", [1, 2])
def test_eam_sharded_grad_matches_replicated(setup, num_buckets):
    scene, target = setup
    params = eam.Params(slices=16, random=False, extinction=60.0)
    mesh = make_mesh(8, space=NUM_SLABS)
    grad_fn = make_sharded_grad(mesh, scene, params, H, W, FRAMES,
                                NUM_SLABS, expected=eam_expected,
                                num_buckets=num_buckets)
    slabs = place_slabs(scene.volume, mesh, NUM_SLABS)
    loss_s, body_g = grad_fn(slabs, target, jnp.float32(0.0))

    def loss(voxels):
        sc = dataclasses.replace(
            scene, volume=voxels,
            volume_packed=sampling.pack_corner_volume(voxels),
            transfer_packed=sampling.pack_corner_texture2d(scene.transfer))
        img = eam_expected(sc, params, H, W, FRAMES)
        return jnp.mean((img[..., :3] - target) ** 2)

    loss_r, g_r = jax.value_and_grad(loss)(scene.volume)

    assert np.isclose(float(loss_s), float(loss_r), rtol=1e-6)
    joined = np.asarray(body_g).reshape(scene.volume.shape)
    ref = np.asarray(g_r)
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.allclose(joined, ref, atol=1e-5 * scale)
    # interior slab-boundary planes carry gradient mass — the halo-plane
    # ppermute really lands on the owner
    ds = scene.volume.shape[0] // NUM_SLABS
    for k in range(1, NUM_SLABS):
        assert np.abs(ref[k * ds]).max() > 0
        assert np.allclose(joined[k * ds], ref[k * ds], atol=1e-5 * scale)


def test_mcm_sharded_grad_bucket_invariance(setup):
    """Bucketing only regroups the differentiable inputs; the sampled
    paths and the gradient must be identical across bucket counts."""
    scene, target = setup
    params = mcm.Params(extinction=25.0, steps=8)
    mesh = make_mesh(8, space=NUM_SLABS)
    slabs = place_slabs(scene.volume, mesh, NUM_SLABS)
    results = []
    for nb in (1, 2, 4):
        grad_fn = make_sharded_grad(mesh, scene, params, H, W, FRAMES,
                                    NUM_SLABS, num_buckets=nb)
        loss, g = grad_fn(slabs, target, jnp.float32(0.45))
        results.append((float(loss), np.asarray(g)))
    l0, g0 = results[0]
    assert np.abs(g0).max() > 0
    for loss, g in results[1:]:
        assert loss == l0
        assert np.allclose(g, g0, atol=1e-7)


def test_mcm_sharded_grad_runs_and_is_finite(setup):
    scene, target = setup
    params = mcm.Params(extinction=25.0, steps=8)
    mesh = make_mesh(8, space=NUM_SLABS)
    grad_fn = make_sharded_grad(mesh, scene, params, H, W, FRAMES,
                                NUM_SLABS)
    slabs = place_slabs(scene.volume, mesh, NUM_SLABS)
    loss, g = grad_fn(slabs, target, jnp.float32(0.45))
    assert np.isfinite(float(loss))
    g = np.asarray(g)
    assert g.shape == (NUM_SLABS, 16 // NUM_SLABS, 16, 16, 1)
    assert np.isfinite(g).all() and np.abs(g).max() > 0


def test_rehalo_matches_shard_volume_with_halo(setup):
    scene, _ = setup
    mesh = make_mesh(8, space=NUM_SLABS)
    ref = np.asarray(shard_volume_with_halo(scene.volume, NUM_SLABS))
    bodies = jax.device_put(
        ref[:, :-1],
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("space", None, None, None,
                                             None)))
    out = np.asarray(rehalo(bodies, mesh))
    assert np.array_equal(out, ref)


def _fit_loop(grad_fn, mesh, target, body0, steps_range, mom=None,
              lr=0.05, beta=0.9):
    body = body0
    mom = jnp.zeros_like(body0) if mom is None else mom
    for i in steps_range:
        slabs = rehalo(body, mesh)
        loss, g = grad_fn(slabs, target, jnp.float32(0.1 + 0.013 * i))
        mom = beta * mom + g
        body = jnp.clip(body - lr * mom, 0.0, 1.0)
    return body, mom


def test_sharded_fit_checkpoint_resume_bit_identical(setup, tmp_path):
    """End-to-end sharded-fit rehearsal: run the
    make_sharded_grad training loop on the virtual mesh, checkpoint the
    sharded optimizer state mid-run with checkpoint.save_sharded, restore
    it with the shardings attached, and assert the continuation is
    bit-identical to the uninterrupted run; the deterministic EAM loss
    must also descend.  (Descent cannot be asserted for MCM at a fixed
    seed: the analog value of the ratio-weight estimator is stepwise
    constant in the voxels — the same structural fact that blinds CRN
    finite differences, tests/test_gradient_oracles.py; its resume
    identity is covered
    below.)"""
    from vpt_jax.runtime import checkpoint

    scene, target = setup
    params = eam.Params(slices=16, random=False, extinction=60.0)
    mesh = make_mesh(8, space=NUM_SLABS)
    grad_fn = make_sharded_grad(mesh, scene, params, H, W, FRAMES,
                                NUM_SLABS, expected=eam_expected)
    slabs0 = place_slabs(scene.volume, mesh, NUM_SLABS)
    body0 = slabs0[:, :-1]

    # uninterrupted run: 6 steps; the EAM loss is deterministic, so the
    # fit must strictly descend
    body, _ = _fit_loop(grad_fn, mesh, target, body0, range(6))
    final_plain = np.asarray(body)
    loss_start = float(grad_fn(rehalo(body0, mesh), target,
                               jnp.float32(0.0))[0])
    loss_end = float(grad_fn(rehalo(body, mesh), target,
                             jnp.float32(0.0))[0])
    assert loss_end < loss_start

    # interrupted run: 3 steps, checkpoint, restore, 3 more steps
    body, mom = _fit_loop(grad_fn, mesh, target, body0, range(3))
    checkpoint.save_sharded(tmp_path / "ckpt", "eam-fit",
                            {"body": body, "mom": mom}, frame_number=3,
                            params=params)
    del body, mom

    example = {"body": jnp.zeros_like(body0), "mom": jnp.zeros_like(body0)}
    key, state, frame_number, meta = checkpoint.load_sharded(
        tmp_path / "ckpt", state_example=example)
    assert key == "eam-fit" and frame_number == 3
    assert meta["params"]["slices"] == 16
    # restored arrays carry the mesh sharding of the example
    assert state["body"].sharding.is_equivalent_to(body0.sharding,
                                                   body0.ndim)
    body, _ = _fit_loop(grad_fn, mesh, target, state["body"], range(3, 6),
                        mom=state["mom"])
    assert np.array_equal(np.asarray(body), final_plain)


def test_sharded_mcm_fit_resume_bit_identical(setup, tmp_path):
    """The flagship MCM sharded fit: 2 steps + checkpoint + 2 steps must be
    bit-identical to 4 uninterrupted steps (score-function gradients and
    the sharded halo exchange included)."""
    from vpt_jax.runtime import checkpoint

    scene, target = setup
    params = mcm.Params(extinction=25.0, steps=8)
    mesh = make_mesh(8, space=NUM_SLABS)
    grad_fn = make_sharded_grad(mesh, scene, params, H, W, FRAMES,
                                NUM_SLABS)
    slabs0 = place_slabs(scene.volume, mesh, NUM_SLABS)
    body0 = slabs0[:, :-1]

    body, _ = _fit_loop(grad_fn, mesh, target, body0, range(4), lr=0.5)
    final_plain = np.asarray(body)
    assert np.abs(final_plain - np.asarray(body0)).max() > 0

    body, mom = _fit_loop(grad_fn, mesh, target, body0, range(2), lr=0.5)
    checkpoint.save_sharded(tmp_path / "mcm_ckpt", "mcm-fit",
                            {"body": body, "mom": mom}, frame_number=2)
    example = {"body": jnp.zeros_like(body0), "mom": jnp.zeros_like(body0)}
    _, state, _, _ = checkpoint.load_sharded(tmp_path / "mcm_ckpt",
                                             state_example=example)
    body, _ = _fit_loop(grad_fn, mesh, target, state["body"], range(2, 4),
                        mom=state["mom"], lr=0.5)
    assert np.array_equal(np.asarray(body), final_plain)
