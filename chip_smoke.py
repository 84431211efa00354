"""Smoke run of the main paths on the GPU: viewer, renderers, capacity, fit.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded phase only

Phases (each a function whose sizes are arguments, so the CPU tests run
them small):

- device: the backend must be the GPU (JAX falls back to the CPU when its
  CUDA plugin fails to load, and that fallback must not pass); prints the
  device kind and count and the card's name and power limit.
- capacity: one MCM frame on the 512³ corner-packed bf16 scene, and the
  device's peak memory.
- serve: the interactive deployment (blobs:256, MCM steps=8, fast
  precision, sRGB TF, auto tracking, 512² viewport) behind the HTTP
  viewer, answering a reset frame, two continuations, a camera change and
  a TF edit.
- renderers: all eight renderers at 512² on 256³ (fast path timed and
  compared with the exact float32 oracle), and the exact path on the GPU
  compared with the same program on the host CPU at 128² on 64³.
- fit: three Adam steps of the MCM inverse fit at 256³, and the GPU
  gradient compared with the CPU gradient at 32³.
- four-cards: data-parallel MCM, the halo and resident-handoff frames and
  the sharded EAM gradient, each compared with its one-card counterpart.

The last line of stdout is one JSON object naming the device; a failed
phase raises, so the script exits nonzero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np


def _say(msg: str) -> None:
    print(msg, flush=True)


def _sync(x):
    import jax

    return jax.block_until_ready(x)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- device -----------------------------------------------------------------

def phase_device() -> dict:
    import jax

    from vpt_jax.runtime import device

    device.require_gpu()
    info = device.device_summary()
    _say(f"# device: {info['kind']} x{info['count']} "
         f"({info['platform']}, jax {jax.__version__})")
    _say(f"# card: {device.card_report()}")
    return info


# -- capacity ---------------------------------------------------------------

def phase_capacity(size: int = 512, res: int = 512) -> dict:
    """One MCM frame on the bf16 corner-packed ``size``³ sphere (the
    largest single-card scene; 2.1 GiB table at 512³, 4.3 GiB transient
    while packing)."""
    import jax
    import jax.numpy as jnp

    from vpt_jax import transfer, volume
    from vpt_jax.renderers import make_scene, mcm

    t0 = time.perf_counter()
    scene = make_scene(volume.sphere_volume(size),
                       transfer.gray_ramp(alpha_scale=0.8), pack=True,
                       pack_dtype=jnp.bfloat16, tf_mxu=True)
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=8)
    state = mcm.reset(params, res, res, scene)
    state = _sync(jax.jit(mcm.render_frame)(
        state, scene, params, jnp.float32(0.123), jnp.int32(1)))
    dt = time.perf_counter() - t0
    radiance = np.asarray(state["radiance"])
    _check(np.isfinite(radiance).all(), "capacity: non-finite radiance")
    table_gib = scene.volume_packed.nbytes / 2 ** 30
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    peak_txt = f"{peak / 2 ** 30:.2f} GiB" if peak else "not reported"
    _say(f"# capacity: MCM {res}^2 on {size}^3 packed bf16, table "
         f"{table_gib:.2f} GiB, first frame {dt:.1f} s incl. pack+compile, "
         f"peak_bytes_in_use {peak_txt}")
    return {"table_gib": table_gib, "peak_bytes_in_use": peak}


# -- serve ------------------------------------------------------------------

def _get(url: str, data: bytes | None = None) -> tuple[bytes, float]:
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, data=data, timeout=600) as resp:
        body = resp.read()
    return body, time.perf_counter() - t0


def phase_serve(size: int = 256, res: int = 512) -> dict:
    """The interactive deployment behind the HTTP viewer."""
    from vpt_jax import transfer, volume
    from vpt_jax.io.image import decode_png
    from vpt_jax.runtime import RenderingContext
    from vpt_jax.runtime.viewer import ViewerServer

    ctx = RenderingContext(resolution=res, precision="fast",
                           tracking="auto", tf_srgb=True)
    ctx.set_volume(volume.blobs_volume(size))
    ctx.set_transfer_function(transfer.gray_ramp(alpha_scale=1.0))
    ctx.choose_renderer("mcm")
    ctx.choose_tone_mapper("reinhard")
    server = ViewerServer(ctx, port=0)
    port = server.serve_background()
    base = f"http://127.0.0.1:{port}"
    bump = [{"position": {"x": 0.6, "y": 0.5}, "size": {"x": 0.2, "y": 0.5},
             "color": {"r": 1, "g": 0.6, "b": 0.3, "a": 0.9}}]
    try:
        first, t_first = _get(base + "/frame?reset=1&spp=1")
        conts = [_get(base + "/frame?spp=1") for _ in range(2)]
        moved = _get(base + "/frame?spp=1&yaw=0.6&pitch=0.2")
        _get(base + "/tf", data=json.dumps(bump).encode())
        edited = _get(base + "/frame?spp=1&yaw=0.6&pitch=0.2")
    finally:
        server.shutdown()
    frames = [first] + [b for b, _ in conts + [moved, edited]]
    for body in frames:
        px = decode_png(body)
        _check(px.shape == (res, res, 3), f"serve: frame shape {px.shape}")
    _check(np.asarray(decode_png(edited[0]), np.int32).sum() > 0,
           "serve: blank frame after TF edit")
    t_cont = [dt for _, dt in conts]
    _say(f"# serve: blobs:{size} MCM steps=8 fast/srgb/auto {res}^2 — "
         f"first image {t_first * 1e3:.1f} ms (scene build + compile), "
         f"continuations {', '.join(f'{t * 1e3:.1f}' for t in t_cont)} ms, "
         f"camera change {moved[1] * 1e3:.1f} ms, "
         f"TF edit + frame {edited[1] * 1e3:.1f} ms")
    return {"first_image_s": t_first, "continuation_s": t_cont,
            "camera_change_s": moved[1], "tf_edit_frame_s": edited[1]}


# -- renderers ----------------------------------------------------------------

#: bf16 corner/TF tables keep ~8 bits of fraction: the fast path's
#: tolerance against the exact oracle (tests/test_sampling.py's bf16 table
#: check).  Compared as a mean per pixel for the marchers; the MC
#: renderers' fast scenes may engage cheb-skip, which changes the RNG
#: stream, so they compare image means.
FAST_TOL = 2e-2
#: GPU vs CPU exact path: transcendentals and FMA contraction differ by a
#: few ulps between the two compilers
MARCH_TOL = 1e-4
#: DOS's 200-slice occlusion recurrence (floored tap offsets, in/out
#: tests) amplifies those ulps: on the CPU a 1-ulp camera change moves its
#: image ~100x more than EAM's, and on the GPU most pixels sit ~1e-4 off
#: the CPU.  It is held to a max of DOS_TOL and the image-mean bound.
DOS_TOL = 2e-3
#: GLSL-exact MC streams (MCM, MCS, LAO): an ulp can flip a rare
#: free-flight decision, so these compare the share of agreeing pixels and
#: the image mean
MC_KEYS = ("lao", "mcm", "mcs")
MC_AGREE = 0.999
MC_MEAN_RTOL = 1e-3


def _render(r, scene, frames):
    """Reset renderer ``r`` on ``scene``, render ``frames`` progressive
    frames from a fixed seed sequence, return the display image."""
    r.reset(scene)
    for i in range(frames):
        r.render(scene, (0.1 + 0.173 * i) % 1.0)
    return _sync(r.display(scene))


def _pixel_agreement(a, b, key, state_a, state_b):
    """Share of pixels whose outcome matches: equal ``samples`` counters
    for MCM, colour within MARCH_TOL otherwise."""
    if key == "mcm":
        return float(np.mean(np.asarray(state_a["samples"])
                             == np.asarray(state_b["samples"])))
    return float(np.mean(np.max(np.abs(a - b), axis=-1) <= MARCH_TOL))


def rng_streams_match(res: int = 128) -> bool:
    """The integer PCG streams on the default device and the host CPU,
    bit for bit: per-pixel seeding plus 16 draws."""
    import jax
    import jax.numpy as jnp

    from vpt_jax import rng, sampling

    def streams(seed):
        state = rng.seed_pixels(sampling.pixel_ndc(res, res), seed)
        out = []
        for _ in range(16):
            state, _ = rng.uniform(state)
            out.append(state)
        return jnp.stack(out)

    fn = jax.jit(streams)
    dev = np.asarray(fn(jnp.float32(0.37)))
    with jax.default_device(jax.devices("cpu")[0]):
        host = np.asarray(fn(jnp.float32(0.37)))
    return bool(np.array_equal(dev, host))


def phase_renderers(size: int = 256, res: int = 512, timed_frames: int = 3,
                    check_size: int = 64, check_res: int = 128,
                    check_frames: int = 4, keys=None) -> dict:
    import jax
    import jax.numpy as jnp

    from vpt_jax import transfer, volume
    from vpt_jax.renderers import MODULES, make_renderer, make_scene

    keys = sorted(MODULES) if keys is None else keys
    tf = transfer.gray_ramp(alpha_scale=0.8)
    vol = volume.blobs_volume(size, seed=3, count=6)
    fast = make_scene(vol, tf, pack_dtype=jnp.bfloat16, tf_mxu=True,
                      tracking="auto")
    exact = make_scene(vol, tf, pack=False)
    rows, failed = {}, []
    for key in keys:
        r = make_renderer(key, height=res, width=res)
        a = np.asarray(_render(r, fast, 1))      # compiles the fast path
        t0 = time.perf_counter()
        for i in range(timed_frames):
            r.render(fast, 0.31 + 0.1 * i)
        _sync(r.state)
        ms = (time.perf_counter() - t0) / timed_frames * 1e3
        b = np.asarray(_render(r, exact, 1))
        if key in ("mcm", "mcs"):
            err = abs(float(a.mean()) - float(b.mean()))
            how = "|mean diff|"
        else:
            err = float(np.mean(np.abs(a - b)))
            how = "mean |diff|"
        rows[key] = {"ms_per_frame": ms, "fast_vs_exact": err}
        _say(f"# renderer {key}: {ms:.2f} ms/frame at {res}^2 on {size}^3 "
             f"(fast path); fast vs exact {how} {err:.2e} "
             f"(tol {FAST_TOL:g})")
        if not (np.isfinite(a).all() and np.isfinite(b).all()
                and err <= FAST_TOL):
            failed.append(f"{key} fast path")

    # exact path, this device vs the host CPU
    cpu = jax.devices("cpu")[0]
    small = volume.blobs_volume(check_size, seed=3, count=6)
    dev_scene = make_scene(small, tf, pack=False)
    with jax.default_device(cpu):
        cpu_scene = make_scene(small, tf, pack=False)
    for key in keys:
        rd = make_renderer(key, height=check_res, width=check_res)
        rc = make_renderer(key, height=check_res, width=check_res)
        a = np.asarray(_render(rd, dev_scene, check_frames))
        with jax.default_device(cpu):
            b = np.asarray(_render(rc, cpu_scene, check_frames))
        err = float(np.max(np.abs(a - b)))
        agree = _pixel_agreement(a, b, key, rd.state, rc.state)
        mean_rel = abs(float(a.mean()) - float(b.mean())) / max(
            abs(float(b.mean())), 1e-12)
        rows[key].update(device_vs_cpu_max_abs=err,
                         device_vs_cpu_agree=agree,
                         device_vs_cpu_mean_rel=mean_rel)
        if key in MC_KEYS:
            ok = agree >= MC_AGREE and mean_rel <= MC_MEAN_RTOL
            rule = (f"needs agree >= {MC_AGREE}, mean rel <= "
                    f"{MC_MEAN_RTOL:g}")
        elif key == "dos":
            ok = err <= DOS_TOL and mean_rel <= MC_MEAN_RTOL
            rule = f"needs max <= {DOS_TOL:g}, mean rel <= {MC_MEAN_RTOL:g}"
        else:
            ok = err <= MARCH_TOL
            rule = f"needs max <= {MARCH_TOL:g}"
        _say(f"# renderer {key}: device vs cpu at {check_res}^2 on "
             f"{check_size}^3, {check_frames} frames: max |diff| "
             f"{err:.2e}, {agree:.5f} of pixels agree, mean rel diff "
             f"{mean_rel:.2e} ({rule}: {'ok' if ok else 'FAIL'})")
        if not ok:
            failed.append(f"{key} device vs cpu")
    same = rng_streams_match(check_res)
    _say(f"# rng: PCG streams bit-identical on device and cpu: {same}")
    if not same:
        failed.append("rng streams")
    _check(not failed, "renderers: " + ", ".join(failed))
    return rows


# -- fit ----------------------------------------------------------------------

#: GPU vs CPU voxel gradient of the MC fit, relative L2
GRAD_RTOL = 1e-3


def _fit_setup(size, res, frames, target_frames):
    """Truth blobs, a dimmed initial guess and the fit's (loss_fn, step,
    optimizer) on an MCM target rendered from the truth volume."""
    import jax.numpy as jnp

    from vpt_jax import train, transfer, volume
    from vpt_jax.renderers import make_renderer, make_scene, mcm

    truth = volume.blobs_volume(size, seed=3, count=6).data
    tf = transfer.gray_ramp(alpha_scale=0.9)
    params = mcm.Params(extinction=25.0, anisotropy=0.2, steps=8)
    r = make_renderer("mcm", params=params, height=res, width=res)
    target = r.render_progressive(
        make_scene(truth, tf, pack_dtype=jnp.bfloat16, tf_mxu=True),
        frames=target_frames)
    template = make_scene(truth, tf, pack=False)
    loss_fn, step, optimizer = train.make_mc_fit(
        target, template, "mcm", params, frames, learning_rate=5e-4)
    leaves = {"volume": jnp.clip(0.55 * truth, 0.0, 1.0)}
    return loss_fn, step, optimizer, leaves


def phase_fit(size: int = 256, res: int = 256, frames: int = 4,
              steps: int = 3, target_frames: int = 64,
              check_size: int = 32, check_res: int = 32) -> dict:
    import jax
    import jax.numpy as jnp

    _, step, optimizer, leaves = _fit_setup(size, res, frames,
                                            target_frames)
    opt_state = optimizer.init(leaves)
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        loss, grads, leaves, opt_state = _sync(
            step(leaves, opt_state, jnp.float32(0.1 + 0.013 * i)))
        times.append(time.perf_counter() - t0)
        g = np.asarray(grads["volume"])
        _check(np.isfinite(float(loss)),
               f"fit: loss {float(loss)} at step {i}")
        _check(np.isfinite(g).all(), f"fit: non-finite gradient at step {i}")
    s_per_step = float(np.mean(times[1:])) if steps > 1 else times[0]
    _say(f"# fit: MCM {size}^3, {res}^2 target, {frames} grad frames — "
         f"{s_per_step:.3f} s/step (steps 2..{steps}; first step "
         f"{times[0]:.1f} s incl. compile), last loss {float(loss):.3e}")

    # the same gradient on this device and on the host CPU
    loss_fn, _, _, small = _fit_setup(check_size, check_res, frames, 16)
    grad = jax.jit(jax.grad(loss_fn))
    g_dev = np.asarray(grad(small, jnp.float32(0.25))["volume"])
    with jax.default_device(jax.devices("cpu")[0]):
        loss_c, _, _, small_c = _fit_setup(check_size, check_res, frames, 16)
        g_cpu = np.asarray(jax.jit(jax.grad(loss_c))(
            small_c, jnp.float32(0.25))["volume"])
    rel = float(np.linalg.norm(g_dev - g_cpu)
                / max(np.linalg.norm(g_cpu), 1e-30))
    _say(f"# fit: device vs cpu voxel gradient at {check_size}^3: "
         f"relative L2 {rel:.2e} (tol {GRAD_RTOL:g})")
    _check(rel <= GRAD_RTOL, "fit: device and cpu gradients disagree")
    return {"s_per_step": s_per_step, "grad_rel_l2": rel}


# -- four cards ---------------------------------------------------------------

#: the sharding invariant (tests/test_halo.py, tests/test_resident.py):
#: discrete fields (the sampled paths) bit for bit; floats to the FMA
#: contraction XLA picks per program, which reaches a few ulps on the
#: transmittance products between the sharded and the one-card program —
#: 1e-6 absolute below 1, relative above (radiance exceeds 1)
SHARD_FLOAT_TOL = 1e-6


def _shard_diff(ref, got) -> tuple[int, float]:
    """(discrete mismatches, float max |diff| / max(1, |ref|)) between two
    MCM states."""
    bad = sum(int(np.sum(np.asarray(ref[k]) != np.asarray(got[k])))
              for k in ("samples", "bounces"))
    err = max(float(np.max(np.abs(np.asarray(ref[k]) - np.asarray(got[k]))
                           / np.maximum(1.0, np.abs(np.asarray(ref[k])))))
              for k in ("position", "direction", "transmittance",
                        "radiance"))
    return bad, err


def _check_shard(name, ref, got, mesh_devices):
    bad, err = _shard_diff(ref, got)
    devs = {d.id for d in mesh_devices}
    _say(f"# four-cards {name}: {bad} discrete mismatches, float max "
         f"|diff|/max(1,|ref|) {err:.2e} (tol {SHARD_FLOAT_TOL:g}), devices "
         f"{sorted(devs)}")
    _check(bad == 0 and err <= SHARD_FLOAT_TOL,
           f"four-cards {name}: sharded render differs from one card")


def _spread(arr) -> set:
    """Devices holding a shard of ``arr``."""
    return {s.device.id for s in arr.addressable_shards}


def phase_four_cards(n_devices: int = 4, dp_size: int = 256,
                     dp_res: int = 1024, sp_size: int = 512,
                     sp_res: int = 1024, train_size: int = 256,
                     train_res: int = 256) -> dict:
    import jax
    import jax.numpy as jnp

    from vpt_jax import transfer, volume
    from vpt_jax.parallel import make_mesh, sharded_scene
    from vpt_jax.parallel.halo import sharded_render_frame as halo_frame
    from vpt_jax.parallel.resident import (
        assemble, resident_render_frame, resident_reset,
    )
    from vpt_jax.parallel.shard import place_state, shard_render_frame
    from vpt_jax.renderers import eam, make_scene, mcm

    _check(len(jax.devices()) >= n_devices,
           f"needs {n_devices} devices, found {len(jax.devices())}")
    one = jax.devices()[0]
    params = mcm.Params(extinction=25.0, steps=8)
    seed, frame = jnp.float32(0.7), jnp.int32(1)

    def single(scene, res):
        scene = jax.device_put(scene, one)
        st = mcm.reset(params, res, res, scene)
        out = jax.jit(mcm.render_frame)(st, scene, params, seed, frame)
        return {k: np.asarray(v) for k, v in out.items()}

    out = {}
    # data-parallel: pixel rows over four cards, scene replicated
    tf = transfer.gray_ramp(alpha_scale=0.8)
    scene = make_scene(volume.blobs_volume(dp_size, seed=3, count=6), tf,
                       pack_dtype=jnp.bfloat16, tf_mxu=True, tracking="auto")
    ref = single(scene, dp_res)
    mesh = make_mesh(n_devices, space=1)
    sc = sharded_scene(scene, mesh)
    state = place_state(mcm.reset(params, dp_res, dp_res, sc), mesh)
    t0 = time.perf_counter()
    got = _sync(shard_render_frame(mcm, mesh, state, donate=False)(
        state, sc, params, seed, frame))
    dt = time.perf_counter() - t0
    _check(len(_spread(got["samples"])) == n_devices,
           "data-parallel state is not spread over every card")
    _check_shard(f"data-parallel MCM {dp_res}^2 on {dp_size}^3 "
                 f"({dt:.1f} s incl. compile)", ref, got, mesh.devices.flat)
    del scene, sc, state, got, ref

    # spatial: the volume in z slabs over four cards (space=4)
    sp_scene = make_scene(volume.blobs_volume(sp_size, seed=5, count=6), tf)
    ref = single(sp_scene, sp_res)
    mesh = make_mesh(n_devices, space=n_devices)
    state = place_state(mcm.reset(params, sp_res, sp_res, sp_scene), mesh)
    fn, slabs = halo_frame(mcm, mesh, sp_scene, n_devices, state)
    _check(len(_spread(jax.tree_util.tree_leaves(slabs)[0])) == n_devices,
           "halo slabs are not spread over every card")
    t0 = time.perf_counter()
    got = _sync(fn(state, slabs, params, seed, frame))
    dt = time.perf_counter() - t0
    _check_shard(f"halo MCM {sp_res}^2 on {sp_size}^3 "
                 f"({dt:.1f} s incl. compile)", ref, got, mesh.devices.flat)
    del slabs, state, got

    pool = resident_reset(sp_scene, params, sp_res, sp_res, mesh,
                          num_slabs=n_devices)
    fn, tables = resident_render_frame(mesh, sp_scene, n_devices, sp_res,
                                       sp_res)
    t0 = time.perf_counter()
    pool = _sync(fn(pool, tables, params, seed, frame))
    dt = time.perf_counter() - t0
    stalled = int(np.asarray(pool["stalled"]).sum())
    migrated = int(np.asarray(pool["migrated"]).sum())
    _say(f"# four-cards resident: migrated {migrated} rows, stalled "
         f"{stalled}")
    _check(stalled == 0, "resident frame stalled photons")
    got = {k: np.asarray(v) for k, v in assemble(pool, sp_res,
                                                  sp_res).items()}
    _check_shard(f"resident MCM {sp_res}^2 on {sp_size}^3 "
                 f"({dt:.1f} s incl. compile)", ref, got, mesh.devices.flat)
    del pool, tables, ref, sp_scene

    # sharded EAM gradient: pixels over data, volume z-slabs over space
    scene = make_scene(volume.blobs_volume(train_size, seed=3, count=6),
                       tf, pack=False)
    eparams = eam.Params(slices=64, random=False)

    def loss(volume_data, sc):
        sc2 = type(sc)(volume=volume_data, transfer=sc.transfer,
                       environment=sc.environment,
                       mvp_inverse=sc.mvp_inverse, model_view=sc.model_view,
                       projection=sc.projection)
        img = eam.generate(sc2, eparams, jnp.float32(0.0), train_res,
                           train_res)
        return jnp.mean(img[..., :3] ** 2)

    grad = jax.jit(jax.value_and_grad(loss))
    scene1 = jax.device_put(scene, one)
    l_ref, g_ref = grad(scene1.volume, scene1)
    mesh = make_mesh(n_devices, space=2)
    sc = sharded_scene(scene, mesh, shard_volume=True)
    l_sh, g_sh = grad(sc.volume, sc)
    g_ref, g_sh = np.asarray(g_ref), np.asarray(g_sh)
    scale = float(np.max(np.abs(g_ref)))
    err = float(np.max(np.abs(g_ref - g_sh)))
    _say(f"# four-cards EAM gradient {train_res}^2 on {train_size}^3, mesh "
         f"{dict(mesh.shape)}: loss {float(l_sh):.6e} vs {float(l_ref):.6e}, "
         f"grad max |diff| {err:.2e} (atol 1e-5 x max|g| = "
         f"{1e-5 * scale:.2e}), devices {sorted(_spread(sc.volume))}")
    _check(len(_spread(sc.volume)) == n_devices,
           "sharded volume is not spread over every card")
    _check(np.isclose(float(l_sh), float(l_ref), rtol=1e-6)
           and err <= 1e-5 * scale,
           "sharded EAM gradient differs from one card")
    out["eam_grad_max_abs"] = err
    return out


# -- main -------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase, on four cards")
    args = ap.parse_args(argv)

    from vpt_jax.runtime import device

    device.enable_compile_cache()
    t0 = time.perf_counter()
    info = phase_device()
    phases = ([phase_four_cards] if args.four_cards else
              [phase_capacity, phase_serve, phase_renderers, phase_fit])
    failed = []
    for phase in phases:
        # every phase runs, so one run reports them all; any failure still
        # fails the run
        try:
            phase()
        except Exception:  # noqa: BLE001 - reported, then fails the run
            traceback.print_exc()
            failed.append(phase.__name__)
    _say(f"# smoke wall time {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
