"""Component-cost profile of the MCM event loop on the live backend.

Times variants of the event loop with individual gather stages replaced by
analytic stand-ins, isolating where per-event time goes (volume gather, TF
gather, event logic), plus candidate fast paths (int8 tables, one-hot TF).
Prints one line per variant: name, ms/frame, events/s.

Usage: python benchmarks/event_cost.py [--size 512] [--frames 20]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp


def timed(fn, state, n):
    state = jax.block_until_ready(fn(state))
    t0 = time.perf_counter()
    for _ in range(n):
        state = fn(state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    from vpt_jax.runtime import device

    device.enable_compile_cache()
    device.require_gpu()

    from vpt_jax import transfer, volume
    from vpt_jax.renderers import make_scene, mcm

    h = w = args.size
    vol = volume.sphere_volume(128)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=args.steps)
    events = h * w * args.steps

    def bench_scene(name, scene):
        state = mcm.reset(params, h, w, scene)
        frame = jax.jit(lambda s: mcm.render_frame(
            s, scene, params, jnp.float32(0.3), jnp.int32(2)),
            donate_argnums=(0,))
        dt = timed(frame, state, args.frames)
        print(f"{name:34s} {dt*1e3:8.2f} ms/frame   "
              f"{events/dt/1e6:8.1f} M events/s")

    def variant(cls, base):
        jax.tree_util.register_pytree_node_class(cls)
        return cls(**{f.name: getattr(base, f.name)
                      for f in dataclasses.fields(base)})

    base = make_scene(vol, tf, pack_dtype=jnp.bfloat16)
    bench_scene("baseline bf16 packed", base)

    # f32 packed for comparison
    bench_scene("f32 packed", make_scene(vol, tf))

    # int8 tables (throughput probe only; dequant scale omitted)
    i8 = dataclasses.replace(
        base,
        volume_packed=(base.volume_packed * 127).astype(jnp.int8),
        transfer_packed=(base.transfer_packed * 127).astype(jnp.int8))
    bench_scene("int8 packed (probe)", i8)

    # analytic TF: skip the TF gather, keep the volume gather
    class NoTF(type(base)):
        def sample_color(self, position):
            rg = self.sample_volume_rg(position)
            v = rg[..., 0:1]
            return jnp.concatenate([v, v, v, v * 0.8], axis=-1)
    no_tf = variant(NoTF, base)
    bench_scene("analytic TF (vol gather only)", no_tf)

    # analytic volume: skip the volume gather, keep the TF gather
    class NoVol(type(base)):
        def sample_volume_rg(self, position):
            d = jnp.sum((position - 0.5) ** 2, axis=-1, keepdims=True)
            v = jnp.clip(1.0 - 4.0 * d, 0.0, 1.0)
            return jnp.concatenate([v, jnp.zeros_like(v)], axis=-1)
    no_vol = variant(NoVol, base)
    bench_scene("analytic volume (TF gather only)", no_vol)

    # no gathers at all: the elementwise event logic alone
    class NoGather(NoVol):
        def sample_color(self, position):
            rg = self.sample_volume_rg(position)
            v = rg[..., 0:1]
            return jnp.concatenate([v, v, v, v * 0.8], axis=-1)
    none = variant(NoGather, base)
    bench_scene("no gathers (event logic only)", none)

    # one-hot TF: post-classified 1D lookup as a bilinear-weight matmul
    # (the production path: sampling.sample_transfer_1d_mxu / tf_mxu=True)
    from vpt_jax import sampling as sampling_mod

    tf1d_tab = sampling_mod.pack_mxu_transfer(tf)        # (TW, 4) y=0 row

    class OneHotTF(type(base)):
        def sample_color(self, position):
            v = self.sample_volume_rg(position)[..., 0]   # (H, W)
            return sampling_mod.sample_transfer_1d_mxu(tf1d_tab, v)
    onehot = variant(OneHotTF, base)
    bench_scene("one-hot 1D TF", onehot)

    # Brick-packed volume: 2x2x2 cells/row -> 8x fewer table rows (3x3x3
    # corner grid per row), separable parity-weighted elementwise contraction
    d, hh, ww, c = base.volume.shape
    vp = base.volume
    vp = jnp.concatenate([vp, vp[:, :, -1:]], axis=2)
    vp = jnp.concatenate([vp, vp[:, -1:]], axis=1)
    vp = jnp.concatenate([vp, vp[-1:]], axis=0)
    grid = jnp.stack([vp[dz:dz + d:2, dy:dy + hh:2, dx:dx + ww:2]
                      for dz in (0, 1, 2) for dy in (0, 1, 2)
                      for dx in (0, 1, 2)], axis=3)     # (D/2,H/2,W/2,27,C)
    nb = (d // 2) * (hh // 2) * (ww // 2)
    brick_tab = jnp.concatenate(
        [grid.reshape(nb, 27 * c),
         jnp.zeros((nb, 32 - 27 * c), grid.dtype)], axis=1
    ).astype(jnp.bfloat16)

    class BrickVol(OneHotTF):
        def sample_volume_rg(self, position):
            dv, hv, wv, cv = self.volume.shape
            dims = jnp.array([wv, hv, dv], jnp.float32)
            u = jnp.clip(position * dims - 0.5, 0.0, dims - 1.0)
            i0 = jnp.floor(u)
            f = (u - i0)[..., None]                       # (..., 3, 1)
            i0 = jnp.clip(i0.astype(jnp.int32), 0,
                          jnp.array([wv - 1, hv - 1, dv - 1], jnp.int32))
            b = i0 >> 1
            par = (i0 & 1).astype(jnp.bool_)[..., None]   # (..., 3, 1)
            rows = jnp.take(
                brick_tab,
                (b[..., 2] * (hv // 2) + b[..., 1]) * (wv // 2) + b[..., 0],
                axis=0).astype(jnp.float32)
            g = rows[..., :27].reshape(rows.shape[:-1] + (3, 3, 3))
            # per-axis weights over the 3-wide corner grid, parity-shifted
            lo = jnp.concatenate([1.0 - f, f, jnp.zeros_like(f)], axis=-1)
            hi = jnp.concatenate([jnp.zeros_like(f), 1.0 - f, f], axis=-1)
            wxyz = jnp.where(par, hi, lo)                 # (..., 3axes, 3)
            gx = jnp.einsum("...zyx,...x->...zy", g, wxyz[..., 0, :])
            gy = jnp.einsum("...zy,...y->...z", gx, wxyz[..., 1, :])
            v = jnp.einsum("...z,...z->...", gy, wxyz[..., 2, :])
            return jnp.stack([v, jnp.zeros_like(v)], axis=-1)
    brick = variant(BrickVol, base)
    bench_scene("brick volume + one-hot TF", brick)

    # Pre-classified baked color volume: TF composed into the voxels
    # (one gather per event; changes numerics - quality/perf mode)
    from vpt_jax import sampling
    baked_rgba = jnp.take(
        jnp.asarray(tf[0], jnp.float32),
        jnp.clip((base.volume[..., 0] * tf.shape[1] - 0.5).astype(jnp.int32),
                 0, tf.shape[1] - 1), axis=0)             # (D,H,W,4) nearest
    baked_packed = sampling.pack_corner_volume(baked_rgba).astype(
        jnp.bfloat16)

    class Baked(type(base)):
        def sample_color(self, position):
            return sampling.sample_volume_packed(
                baked_packed, baked_rgba.shape, position)
    baked = variant(Baked, base)
    bench_scene("baked pre-classified RGBA", baked)


if __name__ == "__main__":
    main()
