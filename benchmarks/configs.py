"""MCM throughput across the BASELINE.md milestone config sizes.

Sweeps image resolution × volume size × events-per-frame on one chip and
prints one JSON line per config — the single-chip complement of
``benchmarks/scaling.py`` (BASELINE configs 2–4 are 256³ volumes and
1024² images; ``bench.py`` pins the 512²/128³ headline).

Each config also reports paths/s (completed deposits — the ray metric);
``majorant=N`` rows run the local-majorant tracking machine
(make_scene(majorant_grid=N), skipgrid.py): same converged image, different
event distribution — iterations/s stays at the gather floor but paths
complete in far fewer iterations on sparse volumes.

Usage: python benchmarks/configs.py [--frames 20]
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp


def bench_config(res: int, vol_n: int, steps: int, frames: int,
                 majorant: int | None = None) -> dict:
    from vpt_jax import transfer, volume
    from vpt_jax.renderers import make_scene, mcm

    vol = volume.sphere_volume(vol_n)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    # pack defaults off above 256³; the 512³ rows force it — the bf16
    # corner table is ~2.1 GiB (packing peaks at the transient f32 table,
    # ~4.3 GiB)
    scene = make_scene(vol, tf, pack=True, pack_dtype=jnp.bfloat16,
                       tf_mxu=True, majorant_grid=majorant)
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=steps)
    state = mcm.reset(params, res, res, scene)
    frame_fn = jax.jit(mcm.render_frame, donate_argnums=(0,))
    total_samples = jax.jit(lambda s: jnp.sum(s["samples"]))

    state = frame_fn(state, scene, params, jnp.float32(0.1), jnp.int32(1))
    paths0 = float(jax.block_until_ready(total_samples(state)))
    t0 = time.perf_counter()
    for i in range(frames):
        state = frame_fn(state, scene, params,
                         jnp.float32(0.2 + 0.001 * i), jnp.int32(i + 2))
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    paths1 = float(total_samples(state))
    events = res * res * steps * frames
    name = f"{res}x{res}/{vol_n}^3/steps{steps}"
    if majorant:
        name += f"/majorant{majorant}"
    return {
        "metric": "mcm_events_per_s",
        "config": name,
        "value": round(events / dt),
        "unit": "events/s",
        "paths_per_s": round((paths1 - paths0) / dt),
        "ms_per_frame": round(dt / frames * 1e3, 2),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="substring filter on the config name "
                         "(e.g. '512^3')")
    args = ap.parse_args()

    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vpt_jax.runtime import device

    device.enable_compile_cache()
    device.require_gpu()
    configs = [
        (512, 128, 8, None),      # bench.py headline
        (512, 128, 32, None),     # deeper event budget per jit step
        (512, 128, 8, 16),        # + local-majorant tracking
        (1024, 128, 8, None),     # BASELINE config-4 image size
        (512, 256, 8, None),      # BASELINE config-2/3 volume size
        (512, 256, 8, 16),        # + local-majorant tracking
        (1024, 256, 8, None),
        (1024, 256, 8, 16),
        (256, 512, 8, None),      # BASELINE config-4 volume, small image
        (512, 512, 8, None),      # 512³ at the headline image size
    ]
    for res, vol_n, steps, majorant in configs:
        name = f"{res}x{res}/{vol_n}^3/steps{steps}"
        if args.only and args.only not in name:
            continue
        print(json.dumps(bench_config(res, vol_n, steps, args.frames,
                                      majorant)), flush=True)


if __name__ == "__main__":
    main()
