import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vpt_jax import tonemap


ALL = sorted(tonemap.TONE_MAPPERS)


@pytest.mark.parametrize("name", ALL)
def test_shapes_and_alpha(name):
    img = jnp.full((4, 4, 4), 0.5, jnp.float32)
    out = tonemap.get(name)(img)
    assert out.shape == (4, 4, 4)
    assert np.allclose(np.asarray(out)[..., 3], 1.0)


@pytest.mark.parametrize("name", [n for n in ALL if n not in ("artistic",)])
def test_monotonic(name):
    xs = jnp.linspace(0.01, 4.0, 64)[:, None] * jnp.ones((1, 3))
    out = np.asarray(tonemap.get(name)(xs))[:, 0]
    assert np.all(np.diff(out) > -1e-5)


def test_reinhard_values():
    img = jnp.array([[[1.0, 1.0, 1.0]]])
    out = np.asarray(tonemap.reinhard(img, exposure=1.0, gamma=1.0))
    assert np.allclose(out[..., :3], 0.5)


def test_unreal_values():
    x = 0.5
    img = jnp.array([[[x, x, x]]])
    out = np.asarray(tonemap.unreal(img, gamma=1.0))
    assert np.allclose(out[..., :3], x / (x + 0.155) * 1.019, atol=1e-6)


def test_aces_clamps_to_unit():
    img = jnp.full((2, 2, 3), 100.0)
    out = np.asarray(tonemap.aces(img))
    assert out[..., :3].max() <= 1.0 + 1e-6


def test_uncharted2_white_maps_near_one():
    img = jnp.full((1, 1, 3), 11.2 / 2.0)  # exposureBias 2 folds in
    out = np.asarray(tonemap.uncharted2(img, gamma=1.0))
    assert np.allclose(out[..., :3], 1.0, atol=1e-3)


def test_range_window():
    img = jnp.array([[[0.25, 0.5, 0.75]]])
    out = np.asarray(tonemap.range_map(img, low=0.25, high=0.75, gamma=1.0))
    assert np.allclose(out[..., :3], [0.0, 0.5, 1.0], atol=1e-6)


def test_artistic_midpoint():
    # with defaults, mid=0.5 maps to 0.5^(1/gamma) relationship folded in
    img = jnp.array([[[0.5, 0.5, 0.5]]])
    out = np.asarray(tonemap.artistic(img, gamma=1.0))
    # exponent = -log(0.5)/log(2) = 1 -> identity at gamma=1
    assert np.allclose(out[..., :3], 0.5, atol=1e-6)


def test_uchimura_linear_section():
    # inside the linear section [m, m+l0): T(x) = m + a(x-m) with a=1 -> x
    x = 0.3
    img = jnp.array([[[x, x, x]]])
    out = np.asarray(tonemap.uchimura(img, gamma=1.0))
    assert np.allclose(out[..., :3], x, atol=1e-3)


@pytest.mark.parametrize("name", ALL)
def test_differentiable(name):
    def loss(x):
        return jnp.sum(tonemap.get(name)(x)[..., :3])

    g = jax.grad(loss)(jnp.full((2, 2, 3), 0.5))
    assert np.all(np.isfinite(np.asarray(g)))


def test_factory_rejects_unknown():
    with pytest.raises(ValueError):
        tonemap.get("nope")


def test_tonemapper_dataclass():
    tm = tonemap.ToneMapper("reinhard", {"exposure": 2.0, "gamma": 1.0})
    out = np.asarray(tm(jnp.array([[[1.0, 1.0, 1.0]]])))
    assert np.allclose(out[..., :3], 2.0 / 3.0, atol=1e-6)
