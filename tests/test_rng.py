import numpy as np
import jax.numpy as jnp

from vpt_jax import rng


def ref_pcg(x):
    x = (x * 747796405 + 2891336453) & 0xFFFFFFFF
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & 0xFFFFFFFF
    return ((x >> 22) ^ x) & 0xFFFFFFFF


def test_pcg_matches_reference_bits():
    xs = np.array([0, 1, 2, 12345, 0xDEADBEEF, 0xFFFFFFFF], dtype=np.uint32)
    got = np.asarray(rng.pcg(jnp.asarray(xs)))
    want = np.array([ref_pcg(int(x)) for x in xs], dtype=np.uint32)
    assert np.array_equal(got, want)


def test_other_hashes_avalanche():
    xs = jnp.arange(1, 1000, dtype=jnp.uint32)
    for h in (rng.lcg, rng.wang, rng.jenkins, rng.xorshift, rng.xxhash):
        out = np.asarray(h(xs))
        assert len(np.unique(out)) > 990  # near-injective on small input


def test_bbs_modular():
    out = int(np.asarray(rng.bbs(jnp.uint32(123456))))
    x = 123456 % 65521
    x = (x * x) % 65521
    x = (x * x) % 65521
    assert out == x


def test_squash_linear_matches_glsl():
    # hash(uvec3) = hash(19x + 47y + 101z + 131)
    x, y, z = 7, 11, 13
    want = ref_pcg((19 * x + 47 * y + 101 * z + 131) & 0xFFFFFFFF)
    got = int(np.asarray(rng.squash_linear(
        [jnp.uint32(x), jnp.uint32(y), jnp.uint32(z)])))
    assert got == want


def test_uniform_range_and_mean():
    state = jnp.arange(100000, dtype=jnp.uint32)
    _, u = rng.uniform(state)
    u = np.asarray(u)
    assert u.min() >= 0.0 and u.max() <= 1.0
    assert abs(u.mean() - 0.5) < 0.01


def test_uniform_chain_matches_scalar_walk():
    state = jnp.uint32(42)
    s, u1 = rng.uniform(state)
    s, u2 = rng.uniform(s)
    s1 = ref_pcg(42)
    s2 = ref_pcg(s1)
    assert np.isclose(float(u1), s1 / 4294967295.0, rtol=1e-7)
    assert np.isclose(float(u2), s2 / 4294967295.0, rtol=1e-7)


def test_uniform_cast_range():
    state = jnp.arange(10000, dtype=jnp.uint32)
    _, u = rng.uniform_cast(state)
    u = np.asarray(u)
    assert u.min() >= 0.0 and u.max() < 1.0


def test_sphere_is_unit():
    state = jnp.arange(10000, dtype=jnp.uint32)
    _, v = rng.sphere(state)
    norms = np.linalg.norm(np.asarray(v), axis=-1)
    assert np.allclose(norms, 1.0, atol=1e-5)
    # roughly isotropic
    mean = np.asarray(v).mean(axis=0)
    assert np.all(np.abs(mean) < 0.05)


def test_hemisphere_upper_half():
    state = jnp.arange(5000, dtype=jnp.uint32)
    _, v = rng.hemisphere(state)
    v = np.asarray(v)
    assert np.all(v[:, 2] >= 0.0)
    assert np.allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)


def test_ball_inside_unit():
    state = jnp.arange(5000, dtype=jnp.uint32)
    _, v = rng.ball(state)
    norms = np.linalg.norm(np.asarray(v), axis=-1)
    assert np.all(norms <= 1.0 + 1e-5)
    # ball mean radius = 3/4
    assert abs(norms.mean() - 0.75) < 0.02


def test_disk_inside_unit():
    state = jnp.arange(5000, dtype=jnp.uint32)
    _, v = rng.disk(state)
    norms = np.linalg.norm(np.asarray(v), axis=-1)
    assert np.all(norms <= 1.0 + 1e-5)
    # uniform disk mean radius = 2/3
    assert abs(norms.mean() - 2.0 / 3.0) < 0.02


def test_circle_on_unit():
    state = jnp.arange(2000, dtype=jnp.uint32)
    _, v = rng.circle(state)
    assert np.allclose(np.linalg.norm(np.asarray(v), axis=-1), 1.0, atol=1e-5)


def test_exponential_mean():
    state = jnp.arange(200000, dtype=jnp.uint32)
    _, d = rng.exponential(state, jnp.float32(4.0))
    d = np.asarray(d)
    assert np.all(d >= 0)
    assert abs(d.mean() - 0.25) < 0.01


def test_normal_moments():
    state = jnp.arange(200000, dtype=jnp.uint32)
    _, x = rng.normal(state)
    x = np.asarray(x)
    assert abs(x.mean()) < 0.02
    assert abs(x.std() - 1.0) < 0.02


def test_seed_pixels_shape_and_determinism():
    ndc = jnp.zeros((4, 4, 2), jnp.float32) + 0.25
    s1 = rng.seed_pixels(ndc, jnp.float32(0.5))
    s2 = rng.seed_pixels(ndc, jnp.float32(0.5))
    s3 = rng.seed_pixels(ndc, jnp.float32(0.6))
    assert s1.shape == (4, 4)
    assert np.array_equal(np.asarray(s1), np.asarray(s2))
    assert not np.array_equal(np.asarray(s1), np.asarray(s3))


def test_float_bits_roundtrip():
    x = jnp.float32(0.123)
    bits = rng.float_bits_to_uint(x)
    back = rng.uint_bits_to_float(bits)
    assert float(back) == float(x)


def test_rand_vec2_in_range():
    p = jnp.array([[0.1, 0.2], [0.5, 0.9]], jnp.float32)
    out = np.asarray(rng.rand_vec2(p))
    assert out.shape == (2, 2)
    assert out.min() >= 0.0 and out.max() < 1.0


def test_btrand_in_range():
    n = jnp.array([1.0, 2.0, 3.0, 4.0], jnp.float32)
    n, v = rng.btrand(n)
    assert 0.0 <= float(v) < 1.0
