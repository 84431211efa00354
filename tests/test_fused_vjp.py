"""Fused select+lerp VJP for the packed volume sampler
(sampling._select_trilerp, Scene(fused_vjp=True)).

Pins the opt-in's contract:

- forward values are BIT-IDENTICAL to the plain packed path (same select,
  same lerp chain) at every fold layout;
- cotangents w.r.t. the packed table match the plain path's (the analytic
  onehot ⊗ w8 outer product vs the native select/lerp transposes — equal up
  to float reassociation);
- positions are DETACHED (d/d position == 0 through the fused fetch) — the
  MC gradient estimators' semantics (diff_mc stop-gradients every position
  input), which is why the mode is opt-in rather than default;
- end to end, diff_mc voxel gradients with fused_vjp=True match the plain
  path and values stay bit-comparable to the analog machine.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vpt_jax import sampling, transfer, volume
from vpt_jax.renderers import diff_mc, make_scene
from vpt_jax.renderers import mcm as mcm_mod


def _positions(n=257, seed=0):
    r = np.random.default_rng(seed)
    # interior + out-of-range (clamp path) + exact voxel centers
    p = r.uniform(-0.2, 1.2, size=(n, 3)).astype(np.float32)
    p[:8] = r.integers(0, 8, size=(8, 3)).astype(np.float32) / 8.0 + 1 / 16.0
    return jnp.asarray(p)


@pytest.mark.parametrize("fold_log2,gather_fold", [
    (0, None),          # unfolded
    (2, None),          # plain fold 4
    (3, 0),             # two-level: stored fold 8, gathered unfolded
])
def test_forward_bit_identical(fold_log2, gather_fold):
    vol = volume.blobs_volume(16, seed=1, count=3).data
    packed = sampling.pack_corner_volume(vol, fold_log2)
    pos = _positions()
    plain = sampling.sample_volume_packed(packed, vol.shape, pos,
                                          gather_fold_log2=gather_fold)
    fused = sampling.sample_volume_packed(packed, vol.shape, pos,
                                          gather_fold_log2=gather_fold,
                                          fused_vjp=True)
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(fused))


@pytest.mark.parametrize("fold_log2,gather_fold", [
    (0, None), (2, None), (3, 0),
])
def test_table_cotangent_matches_plain(fold_log2, gather_fold):
    vol = volume.blobs_volume(16, seed=2, count=3).data
    packed = sampling.pack_corner_volume(vol, fold_log2)
    pos = _positions(seed=3)
    w = jnp.asarray(np.random.default_rng(4).normal(
        size=pos.shape[:-1] + (vol.shape[-1],)).astype(np.float32))

    def loss(tab, fused):
        s = sampling.sample_volume_packed(tab, vol.shape, pos,
                                          gather_fold_log2=gather_fold,
                                          fused_vjp=fused)
        return jnp.sum(s * w)

    g_plain = jax.grad(lambda t: loss(t, False))(packed)
    g_fused = jax.grad(lambda t: loss(t, True))(packed)
    np.testing.assert_allclose(np.asarray(g_fused), np.asarray(g_plain),
                               rtol=1e-6, atol=1e-6)


def test_positions_detached():
    vol = volume.blobs_volume(8, seed=5, count=2).data
    packed = sampling.pack_corner_volume(vol)
    pos = jnp.asarray([[0.31, 0.47, 0.62]], jnp.float32)

    def out(p, fused):
        return jnp.sum(sampling.sample_volume_packed(
            packed, vol.shape, p, fused_vjp=fused))

    g_plain = jax.grad(lambda p: out(p, False))(pos)
    g_fused = jax.grad(lambda p: out(p, True))(pos)
    assert float(jnp.max(jnp.abs(g_plain))) > 0.0   # plain carries d/dp
    np.testing.assert_array_equal(np.asarray(g_fused),
                                  np.zeros_like(np.asarray(g_fused)))


def test_diff_mc_end_to_end():
    n, res, frames = 16, 8, 3
    vol = volume.sphere_volume(n)   # dense: rays collide within the budget
    tf = transfer.gray_ramp(alpha_scale=0.9)
    template = make_scene(vol, tf, pack=False)
    params = mcm_mod.Params(extinction=40.0, anisotropy=0.2, steps=8)
    target = jnp.zeros((res, res, 3), jnp.float32)
    fold = 1  # exercise the folded select path end to end

    def loss(voxels, fused):
        sc = dataclasses.replace(
            template, volume=voxels,
            volume_packed=sampling.pack_corner_volume(voxels, fold),
            transfer_packed=sampling.pack_corner_texture2d(
                template.transfer),
            fused_vjp=fused)
        img = diff_mc.mcm_expected_image(sc, params, res, res, frames,
                                         seed0=0.3)
        return jnp.mean((img - target) ** 2), img

    (l0, img0), g0 = jax.value_and_grad(
        lambda v: loss(v, False), has_aux=True)(template.volume)
    (l1, img1), g1 = jax.value_and_grad(
        lambda v: loss(v, True), has_aux=True)(template.volume)
    # identical forward (same event chain, same RNG stream, same select)
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
    assert float(l0) == float(l1)
    # matching voxel cotangents through pack_corner_volume's VJP
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                               rtol=2e-5, atol=1e-7)
    assert float(jnp.max(jnp.abs(g0))) > 0.0
