"""Two-level fold (sampling.take_rows_twolevel) — forward values identical
to a plain gather on the fwd-fold reshape, and cotangents identical to the
plain path's (the custom VJP only changes the scatter LAYOUT, never the
accumulated values)."""

import jax
import jax.numpy as jnp
import numpy as np

from vpt_jax import sampling


def _rand_table(rng, rows, lanes):
    return jnp.asarray(rng.normal(size=(rows, lanes)).astype(np.float32))


def test_take_twolevel_values_and_grads():
    rng = np.random.default_rng(0)
    base = _rand_table(rng, 512, 8)              # fold-0 layout
    stored = base.reshape(64, 64)                # fold-3 storage (8 cells/row)
    idx = jnp.asarray(rng.integers(0, 512, size=300).astype(np.int32))
    ct = jnp.asarray(rng.normal(size=(300, 8)).astype(np.float32))

    for fwd_fold in (0, 1, 3):
        fidx = idx >> fwd_fold
        got = sampling.take_rows_twolevel(stored, fidx, fwd_fold, 3, 64, 64)
        want = jnp.take(base.reshape(512 >> fwd_fold, 8 << fwd_fold),
                        fidx, axis=0)
        assert np.array_equal(np.asarray(got), np.asarray(want))

        fct = ct if fwd_fold == 0 else jnp.asarray(
            rng.normal(size=(300, 8 << fwd_fold)).astype(np.float32))

        def loss_two(t):
            return jnp.sum(sampling.take_rows_twolevel(
                t, fidx, fwd_fold, 3, 64, 64) * fct)

        def loss_plain(t):
            view = t.reshape(512 >> fwd_fold, 8 << fwd_fold)
            return jnp.sum(jnp.take(view, fidx, axis=0) * fct)

        g_two = np.asarray(jax.grad(loss_two)(stored))
        g_plain = np.asarray(jax.grad(loss_plain)(stored))
        np.testing.assert_allclose(g_two, g_plain, rtol=0, atol=1e-5)


def test_gather_packed_corners_twolevel_matches():
    """Scene-level: a fold-4 table served at gather fold 0/1 must reproduce
    the plain folded gather bit for bit, and voxel-grid gradients through
    sample_volume_packed must agree with the unfolded oracle."""
    rng = np.random.default_rng(1)
    vol = jnp.asarray(rng.uniform(0, 1, (8, 8, 8, 1)).astype(np.float32))
    pos = jnp.asarray(rng.uniform(0, 1, (500, 3)).astype(np.float32))
    want = sampling.sample_volume_packed(
        sampling.pack_corner_volume(vol), vol.shape, pos)
    folded = sampling.pack_corner_volume(vol, 2)
    for gf in (0, 1, None):
        got = sampling.sample_volume_packed(folded, vol.shape, pos,
                                            gather_fold_log2=gf)
        assert np.array_equal(np.asarray(got), np.asarray(want))

    weights = jnp.asarray(rng.normal(size=(500, 1)).astype(np.float32))

    def loss(v, gf, fold):
        packed = sampling.pack_corner_volume(v, fold)
        s = sampling.sample_volume_packed(packed, v.shape, pos,
                                          gather_fold_log2=gf)
        return jnp.sum(s * weights)

    g_oracle = np.asarray(jax.grad(lambda v: loss(v, None, 0))(vol))
    for gf in (0, 1):
        g = np.asarray(jax.grad(lambda v: loss(v, gf, 2))(vol))
        np.testing.assert_allclose(g, g_oracle, rtol=0, atol=1e-5)


def test_twolevel_folds_policy():
    # below the cliff: no fold, plain gather
    assert sampling.twolevel_folds(128 ** 3 // 8, 8, 128) == (0, None)
    # 256^3: fold to exactly 2^18 rows regardless of lane width
    b, g = sampling.twolevel_folds(256 ** 3, 8, 256)
    assert (256 ** 3) >> b == 2 ** 18 and g == 0
    # width caps the fold when it does not divide
    b, g = sampling.twolevel_folds(2 ** 21, 8, 4)
    assert b <= 2
