"""Sequential GLSL-emulation oracles for every renderer, all pixels.

Per-pixel scalar numpy emulations of the reference fragment shaders —
EAMRenderer.glsl:52-80, MIPRenderer.glsl:51-72, ISORenderer.glsl:52-76,
DepthRenderer.glsl:53-79, MCSRenderer.glsl:59-105, DOSRenderer.glsl:56-82,
LAORenderer.glsl:97-191, MCMRenderer.glsl:116-171 — executed exactly as a
fragment invocation would run (sequential march, scalar accumulators, same
RNG chain), checked against the vectorized machines at ≤1e-4 on EVERY
pixel of the frame.  Every marcher — EAM/MIP/ISO/Depth/DOS — and the
flagship MCM run at 33²; LAO runs at the renderer's own defaults
(64 slices, 20-step AO rays).  Progressive accumulation state is covered for every
stateful renderer (MCM photon state over 3 frames, DOS sweep state over
3 frames, MCS incremental-mean integration over 3 frames) and the
``tf_srgb`` GL-texture mode has its own full-frame check.

The samplers here are pure-numpy scalar re-implementations of the GL
fetches (LINEAR + CLAMP_TO_EDGE), so the oracle shares no code with the
vectorized machines.

One deliberate deviation mirrored here: the GLSL loops accumulate
``t += uStepSize`` while the vectorized machines evaluate the equivalent schedule
``t0 + k·step`` (value-equal in exact arithmetic; the schedule form avoids
carried float error), so the emulation uses the schedule form too.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vpt_jax import sampling, transfer, volume
from vpt_jax.renderers import make_scene


# ---------------------------------------------------------------------------
# Pure-numpy scalar GL samplers (float32 op-for-op with sampling.py)
# ---------------------------------------------------------------------------

def _np_trilinear(vol, pos):
    """(D, H, W, C) LINEAR + CLAMP_TO_EDGE fetch at a scalar (3,) position."""
    d, h, w, _ = vol.shape
    dims = np.array([w, h, d], np.float32)
    u = np.clip(pos.astype(np.float32) * dims - np.float32(0.5),
                0.0, dims - 1)
    i0 = np.floor(u).astype(np.int32)
    f = (u - i0).astype(np.float32)
    maxi = np.array([w - 1, h - 1, d - 1], np.int32)
    i0 = np.clip(i0, 0, maxi)
    i1 = np.clip(i0 + 1, 0, maxi)
    x0, y0, z0 = i0
    x1, y1, z1 = i1
    fx, fy, fz = f
    c00 = vol[z0, y0, x0] * (1 - fx) + vol[z0, y0, x1] * fx
    c10 = vol[z0, y1, x0] * (1 - fx) + vol[z0, y1, x1] * fx
    c01 = vol[z1, y0, x0] * (1 - fx) + vol[z1, y0, x1] * fx
    c11 = vol[z1, y1, x0] * (1 - fx) + vol[z1, y1, x1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return (c0 * (1 - fz) + c1 * fz).astype(np.float32)


def _np_bilinear(tex, uv):
    """(H, W, C) bilinear CLAMP_TO_EDGE fetch at a scalar (2,) uv."""
    h, w = tex.shape[:2]
    dims = np.array([w, h], np.float32)
    u = np.clip(uv.astype(np.float32) * dims - np.float32(0.5),
                0.0, dims - 1)
    i0 = np.floor(u).astype(np.int32)
    f = (u - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, np.array([w - 1, h - 1], np.int32))
    c00 = tex[i0[1], i0[0]]
    c10 = tex[i0[1], i1[0]]
    c01 = tex[i1[1], i0[0]]
    c11 = tex[i1[1], i1[0]]
    c0 = c00 * (1 - f[0]) + c10 * f[0]
    c1 = c01 * (1 - f[0]) + c11 * f[0]
    return (c0 * (1 - f[1]) + c1 * f[1]).astype(np.float32)


def _np_sample_color(vol, tf, pos):
    """sampleVolumeColor: TF(volume(p).rg) (MCMRenderer.glsl:85-89)."""
    s = _np_trilinear(vol, pos)
    rg = np.array([s[0], s[1] if s.shape[0] >= 2 else np.float32(0.0)],
                  np.float32)
    return _np_bilinear(tf, rg)


def _py_pcg(x):
    x &= 0xFFFFFFFF
    x = (x * 747796405 + 2891336453) & 0xFFFFFFFF
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & 0xFFFFFFFF
    return ((x >> 22) ^ x) & 0xFFFFFFFF


def _frame_offset(seed):
    """offset = uniform(pcg(bits(seed))) — the per-frame scalar jitter the
    renderers derive from the seed (uOffset = Math.random() in the JS)."""
    state = _py_pcg(int(np.float32(seed).view(np.uint32)))
    state = _py_pcg(state)
    return np.float32(state) / np.float32(4294967295.0)


N = 9
ALL_PIXELS = list(np.ndindex(N, N))
# the wide frame: EAM and MCM — the march archetype and
# the flagship — run their oracles at 33² (13.4× the ray diversity of 9²)
N_WIDE = 33
WIDE_PIXELS = list(np.ndindex(N_WIDE, N_WIDE))


@pytest.fixture(scope="module")
def sc():
    return make_scene(volume.sphere_volume(16),
                      transfer.gray_ramp(alpha_scale=0.9))


class Rays:
    """Scalar ray setup shared by every fragment shader (unproject +
    intersectCube, mixins/unproject.glsl:3-11, intersectCube.glsl:3-12),
    plus pure-numpy GL samplers over the scene's textures."""

    def __init__(self, sc, n=N):
        self.ndc = np.asarray(sampling.pixel_ndc(n, n))
        self.mvp_inv = np.asarray(sc.mvp_inverse)
        self.sc = sc
        self.vol = np.asarray(sc.volume)
        self.tf = np.asarray(sc.transfer)

    def pixel(self, i, j):
        x, y = self.ndc[i, j]
        nearh = self.mvp_inv @ np.array([x, y, -1, 1], np.float32)
        farh = self.mvp_inv @ np.array([x, y, 1, 1], np.float32)
        rf = (nearh[:3] / nearh[3]).astype(np.float32)
        rt = (farh[:3] / farh[3]).astype(np.float32)
        d = rt - rf
        with np.errstate(divide="ignore", invalid="ignore"):
            tmin = (0 - rf) / d
            tmax = (1 - rf) / d
        t1 = np.minimum(tmin, tmax)
        t2 = np.maximum(tmin, tmax)
        tn = max(float(t1.max()), 0.0)
        tf_ = max(float(t2.min()), 0.0)
        start = (rf + np.float32(tn) * d).astype(np.float32)
        end = (rf + np.float32(tf_) * d).astype(np.float32)
        return start, end, np.float32(tn), np.float32(tf_), tn >= tf_

    def sample(self, pos):
        return _np_sample_color(self.vol, self.tf, np.asarray(pos))

    def value(self, pos):
        return float(_np_trilinear(self.vol, np.asarray(pos))[0])


def test_eam_matches_sequential_emulation(sc):
    from vpt_jax.renderers import eam

    params = eam.Params(extinction=60.0, slices=16, random=True)
    seed = np.float32(0.42)
    frame = np.asarray(eam.generate(sc, params, jnp.float32(seed),
                                    N_WIDE, N_WIDE))

    rays = Rays(sc, n=N_WIDE)
    offset = _frame_offset(seed)
    step = np.float32(1.0 / 16)
    for (i, j) in WIDE_PIXELS:
        start, end, _, _, miss = rays.pixel(i, j)
        if miss:
            expect = np.array([0, 0, 0, 1], np.float32)
        else:
            rsl = np.float32(np.linalg.norm(end - start)) * step
            acc = np.zeros(4, np.float32)
            t0 = step * offset
            for k in range(16):
                t = np.float32(t0 + np.float32(k) * step)
                if not (t < 1.0 and acc[3] < 0.99):
                    continue
                c = rays.sample(start + t * (end - start))
                a = np.float32(c[3] * rsl * np.float32(60.0))
                acc[:3] += (1 - acc[3]) * c[:3] * a
                acc[3] += (1 - acc[3]) * a
            rgb = acc[:3] / acc[3] if acc[3] > 1.0 else acc[:3]
            expect = np.array([rgb[0], rgb[1], rgb[2], 1], np.float32)
        assert np.allclose(frame[i, j], expect, atol=1e-4), (i, j)


def test_mip_matches_sequential_emulation(sc):
    from vpt_jax.renderers import mip

    params = mip.Params(steps=16)
    seed = np.float32(0.13)
    frame = np.asarray(mip.generate(sc, params, jnp.float32(seed),
                                    N_WIDE, N_WIDE))

    rays = Rays(sc, n=N_WIDE)
    offset = _frame_offset(seed)
    step = np.float32(1.0 / 16)
    for (i, j) in WIDE_PIXELS:
        start, end, _, _, miss = rays.pixel(i, j)
        if miss:
            expect = np.float32(0.0)
        else:
            val = np.float32(0.0)
            for k in range(16):
                t = np.float32(np.mod(offset + np.float32(k) * step, 1.0))
                c = rays.sample(start + t * (end - start))
                val = max(val, c[3])
        assert np.allclose(frame[i, j], expect if miss else val,
                           atol=1e-4), (i, j)


def test_iso_matches_sequential_emulation(sc):
    from vpt_jax.renderers import iso

    params = iso.Params(isovalue=0.5, steps=16)
    seed = np.float32(0.77)
    frame = np.asarray(iso.generate(sc, params, jnp.float32(seed),
                                    N_WIDE, N_WIDE))

    rays = Rays(sc, n=N_WIDE)
    offset = _frame_offset(seed)
    step = np.float32(1.0 / 16)
    for (i, j) in WIDE_PIXELS:
        start, end, _, _, miss = rays.pixel(i, j)
        closest = np.full(4, -1.0, np.float32)
        if not miss:
            for k in range(16):
                t = np.float32(1.0 - offset * step - np.float32(k) * step)
                pos = start + t * (end - start)
                if rays.sample(pos)[3] >= 0.5:
                    closest = np.array([pos[0], pos[1], pos[2], t],
                                       np.float32)
        assert np.allclose(frame[i, j], closest, atol=1e-4), (i, j)


def test_depth_matches_sequential_emulation(sc):
    from vpt_jax.renderers import depth

    params = depth.Params(extinction=120.0, slices=16, threshold=0.1,
                          random=False)
    frame = np.asarray(depth.generate(sc, params, jnp.float32(0.0),
                                      N_WIDE, N_WIDE))

    rays = Rays(sc, n=N_WIDE)
    step = np.float32(1.0 / 16)
    for (i, j) in WIDE_PIXELS:
        start, end, tn, tf_, miss = rays.pixel(i, j)
        if miss:
            expect = np.float32(-1.0)
        else:
            t, acc = np.float32(0.0), np.float32(0.0)
            while t < 1.0 and acc < 0.1:
                c = rays.sample(start + t * (end - start))
                acc += (1 - acc) * c[3] * np.float32(
                    np.linalg.norm(end - start)) * step * np.float32(120.0)
                t = np.float32(t + step)
            expect = np.float32(tn + t * (tf_ - tn)) if acc >= 0.1 \
                else np.float32(-1.0)
        assert np.allclose(frame[i, j], expect, atol=1e-4), (i, j)


# ---------------------------------------------------------------------------
# MCS — delta-tracking single scattering (MCSRenderer.glsl:59-105)
# ---------------------------------------------------------------------------

def _py_uniform(state):
    state = _py_pcg(state)
    return state, np.float32(state) / np.float32(4294967295.0)


def _py_exponential(state, rate):
    state, u = _py_uniform(state)
    u = max(u, np.float32(1e-38))
    return state, np.float32(-np.log(u) / np.float32(rate))


_TWOPI = np.float32(6.28318530718)


def _mcs_scatter_dir(seed):
    """Per-frame scattering direction: sphere(pcg(bits(seed) ^ golden))."""
    dstate = _py_pcg((int(seed.view(np.uint32)) ^ 0x9E3779B9) & 0xFFFFFFFF)
    dstate, r = _py_uniform(dstate)
    dstate, a = _py_uniform(dstate)
    disk = np.float32(np.sqrt(r)) * np.array(
        [np.cos(_TWOPI * a), np.sin(_TWOPI * a)], np.float32)
    norm = np.float32(disk @ disk)
    return np.array([2 * np.sqrt(max(1 - norm, np.float32(0))) * disk[0],
                     2 * np.sqrt(max(1 - norm, np.float32(0))) * disk[1],
                     1 - 2 * norm], np.float32)


def _emulate_mcs_pixel(rays, sdir, seed, ext, env, i, j):
    """One sequential GLSL execution of the MCS fragment at pixel (i, j):
    sampleDistance consumes 2 draws per continuing iteration and 1 in its
    escaping iteration (MCSRenderer.glsl:70-87); sampleTransmittance
    consumes exactly 1 per iteration (:89-105)."""
    start, end, tn, tf_, miss = rays.pixel(i, j)
    if miss:
        return env
    maxd = np.float32(np.linalg.norm(end - start))
    px = (rays.ndc[i, j] * np.float32(0.5) + np.float32(0.5)).astype(
        np.float32)
    state = _py_pcg((19 * int(px[0].view(np.uint32))
                     + 47 * int(px[1].view(np.uint32))
                     + 101 * int(seed.view(np.uint32)) + 131)
                    & 0xFFFFFFFF)
    # sampleDistance
    dist = np.float32(0.0)
    while True:
        state, d = _py_exponential(state, ext)
        dist = np.float32(dist + d)
        if dist > max(maxd, np.float32(1e-20)):
            break
        pos = (start + (dist / maxd) * (end - start)).astype(np.float32)
        state, u = _py_uniform(state)
        if u < rays.sample(pos)[3]:
            break
    if dist > maxd:
        return env                          # escaped
    t = np.float32(dist / maxd)
    spoint = (start + t * (end - start)).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        tmin = (0 - spoint) / sdir
        tmax = (1 - spoint) / sdir
    tfar = max(float(np.maximum(tmin, tmax).min()), 0.0)
    sto = (spoint + sdir * np.float32(tfar)).astype(np.float32)
    sd = np.float32(np.linalg.norm(sto - spoint))
    diffuse = rays.sample(spoint)
    # sampleTransmittance
    dist2, trans = np.float32(0.0), np.float32(1.0)
    while True:
        state, d = _py_exponential(state, ext)
        ndist = np.float32(dist2 + d)
        if ndist > max(sd, np.float32(1e-20)):
            break
        pos = (spoint + (ndist / sd)[None]
               * (sto - spoint)).astype(np.float32)
        trans = np.float32(trans * (1 - rays.sample(pos)[3]))
        dist2 = ndist
    return diffuse * env * trans


def test_mcs_matches_sequential_emulation(sc):
    """The while_loop delta-tracking machine must reproduce a per-pixel
    sequential GLSL execution (draw-count semantics in
    _emulate_mcs_pixel's docstring)."""
    from vpt_jax.renderers import mcs

    ext = np.float32(40.0)
    params = mcs.Params(extinction=float(ext))
    seed = np.float32(0.29)
    frame = np.asarray(mcs.generate(sc, params, jnp.float32(seed), N, N))

    sdir = _mcs_scatter_dir(seed)
    rays = Rays(sc)
    env = np.array([1, 1, 1, 1], np.float32)   # default 1x1 white env
    for (i, j) in ALL_PIXELS:
        expect = _emulate_mcs_pixel(rays, sdir, seed, ext, env, i, j)
        assert np.allclose(frame[i, j], expect, atol=1e-4), (i, j)


def test_mcs_progressive_integrate_matches_emulation(sc):
    """MCS integrate (MCSRenderer.glsl:173-177 / mcs.render_frame): the
    accumulator advances by the incremental mean acc += (frame − acc)/n
    across THREE progressive frames — emulated per pixel in float32 with
    the same update order."""
    from vpt_jax.renderers import mcs

    ext = np.float32(40.0)
    params = mcs.Params(extinction=float(ext))
    seeds = [np.float32(0.29), np.float32(0.53), np.float32(0.88)]

    state = mcs.reset(params, N, N, sc)
    rays = Rays(sc)
    env = np.array([1, 1, 1, 1], np.float32)
    acc = np.zeros((N, N, 4), np.float32)
    acc[..., 3] = 1.0                          # mcs.reset's alpha init
    for f, seed in enumerate(seeds):
        state = mcs.render_frame(state, sc, params, jnp.float32(seed),
                                 jnp.int32(f + 1))
        sdir = _mcs_scatter_dir(seed)
        for (i, j) in ALL_PIXELS:
            expect = _emulate_mcs_pixel(rays, sdir, seed, ext, env, i, j)
            acc[i, j] = acc[i, j] + (expect - acc[i, j]) / np.float32(f + 1)
        assert np.allclose(np.asarray(state), acc, atol=1e-4), f


# ---------------------------------------------------------------------------
# DOS — view-aligned slice sweep with occlusion buffer
# (DOSRenderer.glsl integrate:66-82, occlusion:56-64; JS sweep
#  DOSRenderer.js:226-254)
# ---------------------------------------------------------------------------

def _np_bilinear_clamp(tex, uv):
    """Scalar re-implementation of the GL bilinear CLAMP_TO_EDGE fetch on a
    single-channel (H, W) texture (sampling.sample_texture2d)."""
    h, w = tex.shape
    dims = np.array([w, h], np.float32)
    u = np.clip(uv * dims - np.float32(0.5), 0.0, dims - 1)
    i0 = np.floor(u).astype(np.int32)
    f = (u - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, np.array([w - 1, h - 1], np.int32))
    c00 = tex[i0[1], i0[0]]
    c10 = tex[i0[1], i1[0]]
    c01 = tex[i1[1], i0[0]]
    c11 = tex[i1[1], i1[0]]
    c0 = c00 * (1 - f[0]) + c10 * f[0]
    c1 = c01 * (1 - f[0]) + c11 * f[0]
    return np.float32(c0 * (1 - f[1]) + c1 * f[1])


def test_dos_matches_sequential_emulation(sc):
    """Full-image numpy emulation of the slice sweep, sequential in slices
    and across 3 PROGRESSIVE frames (the carried depth/color/occlusion
    state): per slice, composite 1−exp(−σΔs) modulated by the previous
    occlusion buffer, then advance the occlusion buffer as the mean of the
    disk taps times the slice transmittance — exactly the ping-pong order
    of the reference (occlusion reads the *previous* buffer)."""
    from vpt_jax.renderers import dos

    params = dos.Params(extinction=60.0, aperture=30.0, steps=10, slices=24,
                        samples=4)
    state = dos.reset(params, N_WIDE, N_WIDE, sc)

    ndc = np.asarray(sampling.pixel_ndc(N_WIDE, N_WIDE))
    mapped = (ndc * 0.5 + 0.5).astype(np.float32)
    mvp_inv = np.asarray(sc.mvp_inverse)
    proj = np.asarray(sc.projection)
    offsets = np.asarray(state["offsets"])
    vol_np = np.asarray(sc.volume)
    tf_np = np.asarray(sc.transfer)
    depth0 = np.float32(state["depth"])
    max_depth = np.float32(state["max_depth"])
    sdist = np.float32(state["slice_distance"])
    occl_extent = np.float32(sdist * np.tan(np.float32(30.0)
                                            * np.pi / 180.0))

    color = np.zeros((N_WIDE, N_WIDE, 4), np.float32)
    occlusion = np.ones((N_WIDE, N_WIDE), np.float32)
    for frame in range(3):
        state = dos.render_frame(state, sc, params, jnp.float32(0.0),
                                 jnp.int32(frame + 1))
        n_active = 0
        for s in range(params.steps):
            depth = np.float32(depth0 + np.float32(s) * sdist)
            if depth > max_depth:
                continue
            n_active += 1
            corrh = proj @ np.array([1.0, 1.0, -depth, 1.0], np.float32)
            corr = (corrh[:3] / corrh[3]).astype(np.float32)
            occl_scale = (corr[:2] * occl_extent).astype(np.float32)

            new_occl = occlusion.copy()
            new_color = color.copy()
            for i in range(N_WIDE):
                for j in range(N_WIDE):
                    ph = mvp_inv @ np.array([ndc[i, j, 0], ndc[i, j, 1],
                                             corr[2], 1.0], np.float32)
                    pos = (ph[:3] / ph[3]).astype(np.float32)
                    if np.any(pos > 1.0) or np.any(pos < 0.0):
                        continue
                    ts = _np_sample_color(vol_np, tf_np, pos)
                    extinction = np.float32(ts[3] * np.float32(60.0))
                    alpha = np.float32(1.0 - np.exp(-extinction * sdist))
                    c = color[i, j]
                    nc = c + np.concatenate(
                        [ts[:3] * occlusion[i, j] * alpha * (1.0 - c[3]),
                         [alpha]]).astype(np.float32)
                    nc[3] = min(nc[3], np.float32(1.0))
                    new_color[i, j] = nc
                    taps = np.float32(0.0)
                    for k in range(params.samples):
                        uv = (mapped[i, j]
                              + offsets[k] * occl_scale).astype(np.float32)
                        taps += _np_bilinear_clamp(occlusion, uv)
                    new_occl[i, j] = (taps / params.samples) \
                        * np.exp(-extinction * sdist)
            color, occlusion = new_color, new_occl
        depth0 = np.float32(depth0 + np.float32(n_active) * sdist)

        assert np.allclose(np.asarray(state["color"]), color,
                           atol=1e-4), frame
        assert np.allclose(np.asarray(state["occlusion"]), occlusion,
                           atol=1e-4), frame
        assert abs(float(state["depth"]) - depth0) < 1e-5, frame

    got_img = np.asarray(dos.display(state, sc, params))
    rgb = 1.0 + (color[..., :3] - 1.0) * color[..., 3:4]
    assert np.allclose(got_img[..., :3], rgb, atol=1e-4)


# ---------------------------------------------------------------------------
# LAO — march with local ambient occlusion + soft shadows
# (LAORenderer.glsl:97-191)
# ---------------------------------------------------------------------------

def test_lao_matches_sequential_emulation(sc):
    """Per-pixel scalar emulation of the LAO fragment shader: front-to-back
    march with 2D TF lookup of (value, |∇|), the per-step AO loop with its
    carried (non-reset) inner accumulator, and the stochastic soft-shadow
    term — all driven by the reference's stateless ``rand`` hash, so the
    emulation is deterministic."""
    from vpt_jax import rng
    from vpt_jax.renderers import lao

    # the renderer's own defaults: slices=64, lao_step_size=0.05 (20 AO
    # ray steps),
    # num_lao_samples=1, num_shadow_samples=10
    params = lao.Params(extinction=80.0)
    frame = np.asarray(lao.generate(sc, params, jnp.float32(0.0), N, N))

    rays = Rays(sc)
    ndc = rays.ndc
    step = np.float32(1.0 / params.slices)
    voxel = np.float32(1.0 / 32.0)

    # vLight = (inverseMvp · [lightPos, 1]).xyz without /w (vertex:25)
    lp = np.array([2.0, 12.0, 3.0, 1.0], np.float32)
    light = (rays.mvp_inv @ lp)[:3].astype(np.float32)
    seed_vec = np.array([3.14, 2.71], np.float32)
    rconst = float(np.asarray(rng.rand_vec2(jnp.asarray(seed_vec)))[0])

    vol_np = np.asarray(sc.volume)
    tf_np = np.asarray(sc.transfer)

    def value_at(p):
        return float(_np_trilinear(vol_np, np.asarray(p))[0])

    def grad_mag_at(p):
        offs = np.eye(3, dtype=np.float32) * voxel
        g = np.array([value_at(p - offs[a]) - value_at(p + offs[a])
                      for a in range(3)], np.float32)
        return float(np.sqrt(g @ g))

    def tf_at(value, gmag):
        return _np_bilinear(tf_np, np.array([value, gmag], np.float32))

    t2s = np.arange(0.001, 1.0, params.lao_step_size, dtype=np.float32)
    tint_lao = np.array([0.15, 0.18, 0.32, 1.0], np.float32)
    tint_shadow = np.array([0.15, 0.18, 0.22, 1.0], np.float32)

    for (i, j) in ALL_PIXELS:
        start, end, _, _, miss = rays.pixel(i, j)
        if miss:
            expect = np.array([0, 0, 0, 1], np.float32)
        else:
            rx = float(np.asarray(rng.rand_vec2(
                jnp.asarray(ndc[i, j] * seed_vec)))[0])
            t0 = np.float32(np.clip(rx * step * 1.5, 0.0, 1.0))
            acc = np.zeros(4, np.float32)
            for k in range(params.slices):
                t = np.float32(t0 + np.float32(k) * step)
                if not (t < 1.0 and acc[3] <= 0.9):
                    continue
                pos = (start + t * (end - start)).astype(np.float32)
                value = value_at(pos)
                gmag = grad_mag_at(pos)

                # local ambient occlusion: carried inner accumulator
                rdir = (np.sign(2 * rx - 1) * (rx / np.sqrt(3.0))
                        * np.ones(3)).astype(np.float32)
                inner = np.float32(0.0)
                for t2 in t2s:
                    half = light + rdir * np.float32(0.19 * t2) - pos
                    half = half / max(np.linalg.norm(half), 1e-10)
                    inner += value_at(pos + half * t2) \
                        * np.float32((1.0 - t2) ** 2)
                carried, total = np.float32(0.0), np.float32(0.0)
                for _ in range(params.num_lao_samples):
                    carried = np.float32(np.clip(carried + inner, 0.0, 1.0))
                    total += carried
                lao_term = total / params.num_lao_samples

                # soft shadows
                sdir = np.array([-1.0 + light[0] * rx,
                                 light[1] + rx * light[2],
                                 -1.0 + 2.0 * rconst], np.float32)
                sdir = (sdir / max(np.linalg.norm(sdir), 1e-10)) \
                    * np.float32(rx)
                vshadow = value_at(pos + sdir * np.float32(0.19))
                contrib = vshadow * (vshadow * 0.2) * np.linalg.norm(sdir)
                contrib = np.clip(contrib * 20.0, 0.0, 1.0)
                soft = np.float32(np.clip((-0.2 + 1.2 * contrib) / 1.3,
                                          0.0, 1.0))

                color = tf_at(value, gmag)
                w1 = np.float32(lao_term * 0.69)
                color = color * (1 - w1) + color * tint_lao * w1
                w2 = np.float32(soft * 0.54)
                color = color * (1 - w2) + color * tint_shadow * w2

                acc[:3] += (1 - acc[3]) * color[:3] * value
                acc[3] += (1 - acc[3]) * value * np.float32(80.0 / 100.0)
            rgb = acc[:3] / max(acc[3], 1e-6) if acc[3] > 1.0 else acc[:3]
            expect = np.array([rgb[0], rgb[1], rgb[2], 1], np.float32)
        assert np.allclose(frame[i, j], expect, atol=1e-4), (i, j)


# ---------------------------------------------------------------------------
# MCM — the flagship null-collision event machine, every pixel, 3 frames of
# persistent photon state (MCMRenderer.glsl:116-171)
# ---------------------------------------------------------------------------

def test_mcm_matches_sequential_emulation_full_frame(sc):
    """Per-pixel sequential emulation of the MCM event machine over THREE
    progressive frames: the photon state (position/direction/bounces/
    transmittance) and the Welford radiance/samples accumulators must carry
    across frames exactly as the 4×RGBA32F MRT ping-pong does."""
    from vpt_jax.renderers import mcm

    params = mcm.Params(extinction=50.0, anisotropy=0.0, max_bounces=8,
                        steps=8)
    seeds = [np.float32(0.37), np.float32(0.61), np.float32(0.93)]
    state = mcm.reset(params, N_WIDE, N_WIDE, sc, seed=0.11)
    state0 = {k: np.asarray(v).copy() for k, v in state.items()}
    for f, seed in enumerate(seeds):
        state = mcm.render_frame(state, sc, params, jnp.float32(seed),
                                 jnp.int32(f + 1))
    got = {k: np.asarray(v) for k, v in state.items()}

    rays = Rays(sc, n=N_WIDE)
    ndc = rays.ndc
    mapped = (ndc * 0.5 + 0.5).astype(np.float32)
    mvp_inv = rays.mvp_inv

    def unproject_rand(state, pos2d):
        draws = []
        for _ in range(4):
            state, u = _py_uniform(state)
            draws.append(u)
        radius = np.float32(np.sqrt(draws[0]))
        angle = _TWOPI * draws[1]
        disk = radius * np.array([np.cos(angle), np.sin(angle)], np.float32)
        near_xy = pos2d + disk * np.float32(0.0)          # blur = 0
        aa = np.array([draws[2], draws[3]], np.float32)
        far_xy = pos2d + (aa * 2 - 1) * np.float32(1.0 / N_WIDE)
        nearh = mvp_inv @ np.array([near_xy[0], near_xy[1], -1, 1],
                                   np.float32)
        farh = mvp_inv @ np.array([far_xy[0], far_xy[1], 1, 1], np.float32)
        return state, nearh[:3] / nearh[3], farh[:3] / farh[3]

    def intersect_near(o, d):
        with np.errstate(divide="ignore", invalid="ignore"):
            tmin = (0 - o) / d
            tmax = (1 - o) / d
        return max(np.minimum(tmin, tmax).max(), 0.0)

    bad = []
    for (i, j) in WIDE_PIXELS:
        ph_pos = state0["position"][i, j].copy()
        ph_dir = state0["direction"][i, j].copy()
        ph_tr = state0["transmittance"][i, j].copy()
        ph_rad = state0["radiance"][i, j].copy()
        ph_b = float(state0["bounces"][i, j])
        ph_s = float(state0["samples"][i, j])

        for seed in seeds:
            px = mapped[i, j]
            st = _py_pcg((19 * int(px[0].view(np.uint32))
                          + 47 * int(px[1].view(np.uint32))
                          + 101 * int(seed.view(np.uint32)) + 131)
                         & 0xFFFFFFFF)
            for _ in range(params.steps):
                st, u = _py_uniform(st)
                dist = -np.log(max(u, np.float32(1e-38))) / np.float32(50.0)
                ph_pos = (ph_pos + dist * ph_dir).astype(np.float32)
                c = rays.sample(ph_pos)
                alpha = c[3]
                p_null = 1 - alpha
                p_scatter = 0.0 if ph_b >= 8 else alpha * c[:3].max()
                p_absorb = 1 - p_null - p_scatter
                st, fortune = _py_uniform(st)
                oob = np.any(ph_pos > 1) or np.any(ph_pos < 0)
                if oob or fortune < p_absorb:
                    r_new = ph_tr * 1.0 if oob else np.zeros(3, np.float32)
                    ph_s += 1
                    ph_rad = ph_rad + (r_new - ph_rad) / np.float32(ph_s)
                    st, f3, t3 = unproject_rand(st, ndc[i, j])
                    d = t3 - f3
                    d = d / np.linalg.norm(d)
                    tn = intersect_near(f3, d)
                    ph_pos = (f3 + np.float32(tn) * d).astype(np.float32)
                    ph_dir = d.astype(np.float32)
                    ph_tr = np.ones(3, np.float32)
                    ph_b = 0
                elif fortune < p_absorb + p_scatter:
                    ph_tr = (ph_tr * c[:3]).astype(np.float32)
                    st, r1 = _py_uniform(st)
                    st, r2 = _py_uniform(st)
                    radius = np.float32(np.sqrt(r1))
                    angle = _TWOPI * r2
                    disk = radius * np.array(
                        [np.cos(angle), np.sin(angle)], np.float32)
                    norm = float(disk @ disk)
                    ph_dir = np.array(
                        [2 * np.sqrt(max(1 - norm, 0.0)) * disk[0],
                         2 * np.sqrt(max(1 - norm, 0.0)) * disk[1],
                         1 - 2 * norm], np.float32)
                    ph_b += 1

        ok = (got["samples"][i, j] == ph_s
              and np.allclose(got["radiance"][i, j], ph_rad, atol=1e-4)
              and np.allclose(got["position"][i, j], ph_pos, atol=1e-3)
              and got["bounces"][i, j] == ph_b
              and np.allclose(got["transmittance"][i, j], ph_tr, atol=1e-4))
        if not ok:
            bad.append((i, j))
    assert not bad, bad


# ---------------------------------------------------------------------------
# tf_srgb — the reference's SRGB8_ALPHA8 TF texture semantics
# (AbstractRenderer.js:31-44; 8-bit quantize + sRGB decode), full frame
# ---------------------------------------------------------------------------

def test_eam_srgb_matches_sequential_emulation():
    """The ``tf_srgb`` GL-texture mode must march through the quantized +
    sRGB-decoded TF exactly: the emulation applies the same conversion to
    its numpy TF copy and re-runs the EAM oracle on every pixel."""
    from vpt_jax.renderers import eam

    sc_srgb = make_scene(volume.sphere_volume(16),
                         transfer.gray_ramp(alpha_scale=0.9), tf_srgb=True)
    params = eam.Params(extinction=60.0, slices=16, random=True)
    seed = np.float32(0.42)
    frame = np.asarray(eam.generate(sc_srgb, params, jnp.float32(seed),
                                    N, N))

    # independent numpy conversion (reference: 8-bit quantize, sRGB->linear)
    tf_f = np.asarray(transfer.gray_ramp(alpha_scale=0.9))
    q = np.round(np.clip(tf_f, 0.0, 1.0) * 255.0).astype(np.float32) / 255.0
    rgb = q[..., :3]
    lin = np.where(rgb <= 0.04045, rgb / 12.92,
                   ((rgb + 0.055) / 1.055) ** 2.4).astype(np.float32)
    tf_np = np.concatenate([lin, q[..., 3:]], axis=-1).astype(np.float32)
    assert np.allclose(tf_np, np.asarray(sc_srgb.transfer), atol=2e-7)

    rays = Rays(sc_srgb)
    rays.tf = tf_np
    offset = _frame_offset(seed)
    step = np.float32(1.0 / 16)
    for (i, j) in ALL_PIXELS:
        start, end, _, _, miss = rays.pixel(i, j)
        if miss:
            expect = np.array([0, 0, 0, 1], np.float32)
        else:
            rsl = np.float32(np.linalg.norm(end - start)) * step
            acc = np.zeros(4, np.float32)
            t0 = step * offset
            for k in range(16):
                t = np.float32(t0 + np.float32(k) * step)
                if not (t < 1.0 and acc[3] < 0.99):
                    continue
                c = rays.sample(start + t * (end - start))
                a = np.float32(c[3] * rsl * np.float32(60.0))
                acc[:3] += (1 - acc[3]) * c[:3] * a
                acc[3] += (1 - acc[3]) * a
            rgb_out = acc[:3] / acc[3] if acc[3] > 1.0 else acc[:3]
            expect = np.array([rgb_out[0], rgb_out[1], rgb_out[2], 1],
                              np.float32)
        assert np.allclose(frame[i, j], expect, atol=1e-4), (i, j)
