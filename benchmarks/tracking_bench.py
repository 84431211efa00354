"""Tracking-machine shootout: exact vs cheb-skip vs majorant grid.

Measures events/s AND paths/s per machine on the two scene classes the
tracking policy has to choose between:

- the dense 512²/128³ headline sphere (gray ramp), in both TF pipelines:
  the float ramp (texel-0 alpha 0.0016 > 0 → nothing is TF-empty → cheb
  declines, policy keeps the exact machine) and the reference's
  SRGB8_ALPHA8 texture semantics (``tf_srgb=True`` — 8-bit alpha rounds
  the near-zero floor to exact 0, the sphere exterior becomes TF-empty),
- a sparse 256³ ball at extinction 100 (the CT-like regime, where empty
  space dominates), comparing all three machines.

Usage: python benchmarks/tracking_bench.py [--frames 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def sparse_ball(n: int, r: float = 0.15, value: float = 0.9):
    g = (np.arange(n, dtype=np.float32) + 0.5) / n - 0.5
    r2 = (g[:, None, None] ** 2 + g[None, :, None] ** 2
          + g[None, None, :] ** 2)
    return jnp.asarray(np.where(r2 < r * r, value, 0.0)
                       .astype(np.float32)[..., None])


def bench(scene, steps: int, frames: int, res: int, extinction: float,
          label: str) -> dict:
    from vpt_jax.renderers import mcm

    params = mcm.Params(extinction=extinction, anisotropy=0.3, steps=steps)
    state = mcm.reset(params, res, res, scene)
    frame_fn = jax.jit(mcm.render_frame, donate_argnums=(0,))
    total = jax.jit(lambda s: jnp.sum(s["samples"]))

    state = frame_fn(state, scene, params, jnp.float32(0.1), jnp.int32(1))
    paths0 = float(jax.block_until_ready(total(state)))
    t0 = time.perf_counter()
    for i in range(frames):
        state = frame_fn(state, scene, params,
                         jnp.float32(0.2 + 0.001 * i), jnp.int32(i + 2))
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    paths1 = float(total(state))
    events = res * res * steps * frames
    row = {
        "config": label,
        "events_per_s": round(events / dt),
        "paths_per_s": round((paths1 - paths0) / dt),
        "ms_per_frame": round(dt / frames * 1e3, 2),
        "mean_path_events": round(events / max(paths1 - paths0, 1.0), 3),
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--skip-dense", action="store_true")
    ap.add_argument("--skip-sparse", action="store_true")
    args = ap.parse_args()
    from vpt_jax import transfer, volume
    from vpt_jax.renderers import make_scene
    from vpt_jax.runtime import device

    device.enable_compile_cache()
    device.require_gpu()

    if not args.skip_dense:
        vol = volume.sphere_volume(128)
        tf = transfer.gray_ramp(alpha_scale=0.8)
        for label, kwargs in (
            ("headline/float-tf/exact", dict(tracking="none")),
            ("headline/float-tf/auto", dict(tracking="auto")),
            ("headline/srgb-tf/exact", dict(tf_srgb=True, tracking="none")),
            ("headline/srgb-tf/auto", dict(tf_srgb=True, tracking="auto")),
        ):
            sc = make_scene(vol, tf, pack_dtype=jnp.bfloat16, tf_mxu=True,
                            **kwargs)
            label += f" [cheb={'on' if sc.tracking_packed is not None else 'off'}]"
            bench(sc, steps=32, frames=args.frames, res=512,
                  extinction=40.0, label=label)

    if not args.skip_sparse:
        vol = sparse_ball(256)
        tf = transfer.gray_ramp(alpha_scale=0.5)
        for label, kwargs in (
            ("sparse256/srgb-tf/exact", dict(tf_srgb=True, tracking="none")),
            ("sparse256/srgb-tf/cheb", dict(tf_srgb=True, tracking="cheb")),
            ("sparse256/srgb-tf/grid16",
             dict(tf_srgb=True, majorant_grid=16)),
        ):
            sc = make_scene(vol, tf, pack_dtype=jnp.bfloat16, tf_mxu=True,
                            **kwargs)
            bench(sc, steps=32, frames=args.frames, res=512,
                  extinction=100.0, label=label)


if __name__ == "__main__":
    main()
