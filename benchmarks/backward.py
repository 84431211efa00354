"""Backward-pass throughput: gradient steps through the differentiable MCM
estimator (BASELINE: "forward + backward march kernels").

Measures events/s for (a) the forward frame, (b) value_and_grad of an
image-MSE loss w.r.t. the voxel grid, for these sampler configurations:

- ``unpacked``: the Scene samples the raw (D, H, W, C) volume — 8 gathers
  per event forward, 8 scatter-adds per event backward.
- ``packed``: the corner table is built from the volume *inside* the
  differentiated function (pack_corner_volume is a dense stack —
  differentiable); 1 gather per event forward, 1 scatter-add backward,
  plus a dense window-sum VJP for the pack itself.
- ``folded``: the corner table additionally folds F consecutive cells into
  one wide row for the backward scatter-add (sampling.scatter_fold_log2;
  the fit_mc layout).
- ``twolevelN``: the two-level fold (sampling.take_rows_twolevel) — the
  table is stored at the scatter's fold while gathers are served at fold
  2^N through a custom-VJP reshape.

Usage: python benchmarks/backward.py [--res 512]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp


def bench(res: int, vol_n: int, steps: int, frames: int, mode: str,
          iters: int = 8) -> dict:
    from vpt_jax import sampling, transfer, volume
    from vpt_jax.renderers import diff_mc, make_scene
    from vpt_jax.renderers import mcm as mcm_mod

    vol = volume.sphere_volume(vol_n)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    template = make_scene(vol, tf, pack=False)
    params = mcm_mod.Params(extinction=40.0, anisotropy=0.3, steps=steps)
    target = jnp.zeros((res, res, 3), jnp.float32)
    packed = mode != "unpacked"
    gather_fold = None
    if mode == "folded":
        fold = sampling.scatter_fold_log2(vol_n ** 3, 8, vol_n)
    elif mode.startswith("twolevel"):
        fold, _ = sampling.twolevel_folds(vol_n ** 3, 8, vol_n)
        gather_fold = min(int(mode[len("twolevel"):] or 0), fold)
    else:
        fold = 0

    def loss_fn(voxels, seed0):
        sc = dataclasses.replace(
            template, volume=voxels,
            volume_packed=(sampling.pack_corner_volume(voxels, fold)
                           if packed else None),
            transfer_packed=(sampling.pack_corner_texture2d(
                template.transfer) if packed else None),
            gather_fold_log2=gather_fold)
        img = diff_mc.mcm_expected_image(sc, params, res, res, frames,
                                         seed0=0.3)
        return jnp.mean((img - target) ** 2)

    fwd = jax.jit(loss_fn)
    bwd = jax.jit(jax.value_and_grad(loss_fn))
    voxels = template.volume

    def run(fn):
        jax.block_until_ready(fn(voxels, 0.0))   # compile + warm
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(voxels, 0.0)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / iters

    t_fwd = run(fwd)
    t_bwd = run(bwd)
    events = res * res * steps * frames
    return {
        "metric": "mcm_grad_events_per_s",
        "config": f"{res}x{res}/{vol_n}^3/steps{steps}x{frames}f/{mode}"
                  + (f"(fold {1 << fold})" if fold else ""),
        "value": round(events / t_bwd),
        "unit": "events/s",
        "forward_events_per_s": round(events / t_fwd),
        "bwd_fwd_ratio": round(t_bwd / t_fwd, 2),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--modes", default="unpacked,packed,folded")
    args = ap.parse_args()
    from vpt_jax.runtime import device

    device.enable_compile_cache()
    device.require_gpu()
    for vol_n in (128, 256):
        for mode in args.modes.split(","):
            print(json.dumps(bench(args.res, vol_n, 8, args.frames,
                                   mode, args.iters)), flush=True)


if __name__ == "__main__":
    main()
