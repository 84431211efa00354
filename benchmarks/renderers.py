"""Per-renderer frame throughput on one card.

Times one progressive frame of each of the eight renderer families at the
reference's default 512² resolution and prints one JSON line per renderer.
The reference's implicit interactive budget is one rAF tick (~16 ms) per
progressive sample (SURVEY.md §6); `within_budget` marks renderers that
beat it.

Usage: python benchmarks/renderers.py [--frames 20] [--size 512]
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp


def bench_renderer(key: str, size: int, frames: int,
                   lao_baked: bool = False) -> dict:
    from vpt_jax import transfer, volume
    from vpt_jax.renderers import factory, make_scene

    vol = volume.sphere_volume(128)
    if lao_baked:
        # opt-in (value, |grad|) fast mode: 1 volume tap replaces 7/slice
        vol = volume.with_lao_gradient(vol)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    scene = make_scene(vol, tf, pack_dtype=jnp.bfloat16, tf_mxu=True)
    if lao_baked:
        from vpt_jax.renderers import lao

        renderer = factory.make_renderer(
            key, params=lao.Params(baked_gradient=True),
            height=size, width=size)
    else:
        renderer = factory.make_renderer(key, height=size, width=size)
    renderer.reset(scene)

    jax.block_until_ready(renderer.render(scene, 0.123))  # compile + warm
    t0 = time.perf_counter()
    for i in range(frames):
        renderer.render(scene, 0.2 + 0.001 * i)
    jax.block_until_ready(renderer.state)
    ms = (time.perf_counter() - t0) / frames * 1e3
    return {
        "renderer": key + ("+baked" if lao_baked else ""),
        "ms_per_frame": round(ms, 2),
        "fps": round(1000.0 / ms, 1),
        "within_budget": ms <= 16.0,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--only", default=None,
                    help="comma-separated renderer keys (default: all)")
    args = ap.parse_args()

    from vpt_jax.renderers import factory
    from vpt_jax.runtime import device

    device.enable_compile_cache()
    device.require_gpu()

    keys = args.only.split(",") if args.only else list(factory.MODULES)
    for key in keys:
        print(json.dumps(bench_renderer(key, args.size, args.frames)),
              flush=True)
        if key == "lao":
            print(json.dumps(bench_renderer(key, args.size, args.frames,
                                            lao_baked=True)), flush=True)


if __name__ == "__main__":
    main()
