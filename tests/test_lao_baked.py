"""LAO baked-gradient fast mode.

Contract (the pack_dtype=bf16 pattern: exact default, validated opt-in
fast mode): the baked |∇| channel equals the in-shader central-difference
stencil EXACTLY at voxel centers; between centers it is the trilinear
interpolation of |∇| rather than |∇| of the interpolant, so full-frame
images are compared at a modest tolerance on a smooth volume.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vpt_jax import sampling, transfer, volume
from vpt_jax.renderers import lao, make_scene


@pytest.fixture(scope="module")
def vols():
    base = volume.sphere_volume(32)
    return base, volume.with_lao_gradient(base)


def test_baked_channel_exact_at_voxel_centers(vols):
    base, baked = vols
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 32, size=(256, 3))
    centers = (idx.astype(np.float32) + 0.5) / 32.0
    pos = jnp.asarray(centers)
    grad = sampling.raw_gradient(base.data, pos, 1.0 / 32.0)
    want = np.asarray(jnp.sqrt(jnp.sum(grad * grad, axis=-1)))
    got = np.asarray(baked.data)[idx[:, 0], idx[:, 1], idx[:, 2], 1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_baked_lao_matches_exact_image(vols):
    base, baked = vols
    tf = transfer.gray_ramp(alpha_scale=0.9)
    n = 24
    params = lao.Params(extinction=80.0, slices=16, lao_step_size=0.2,
                        num_lao_samples=2, num_shadow_samples=3)
    exact = np.asarray(lao.generate(make_scene(base, tf), params,
                                    jnp.float32(0.0), n, n))
    baked_params = lao.Params(**{
        **{f: getattr(params, f) for f in (
            "extinction", "slices", "lao_step_size", "num_lao_samples",
            "num_shadow_samples")}, "baked_gradient": True})
    got = np.asarray(lao.generate(make_scene(baked, tf), baked_params,
                                  jnp.float32(0.0), n, n))
    # smooth volume: interpolated-|∇| vs |∇|-of-interpolant stay close
    assert np.abs(got - exact).max() < 0.03
    assert np.abs(got - exact).mean() < 0.004


def test_baked_mode_requires_two_channels(vols):
    base, _ = vols
    tf = transfer.gray_ramp()
    with pytest.raises(ValueError):
        lao.generate(make_scene(base, tf),
                     lao.Params(baked_gradient=True), jnp.float32(0.0),
                     8, 8)
