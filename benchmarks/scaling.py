"""Multi-chip scaling benchmark: MCM events/s vs device count.

Measures the BASELINE.md scaling-efficiency criterion (≥85% 1→N) on
whatever devices exist: the cards of one host, or the virtual CPU mesh
for harness validation (`XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu python benchmarks/scaling.py --resolution 128`).

For each device count d in 1, 2, 4, …, N: row-shard a (res × res) MCM
progressive render over a ``data`` mesh, run F frames, report events/s and
the efficiency vs the single-device rate.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp


def bench_mesh(n_devices: int, resolution: int, steps: int, frames: int,
               volume_n: int, pack_dtype):
    from vpt_jax import transfer, volume
    from vpt_jax.parallel import make_mesh, sharded_scene
    from vpt_jax.parallel.shard import place_state, shard_render_frame
    from vpt_jax.renderers import make_scene, mcm

    mesh = make_mesh(n_devices, space=1, axes=("data",))
    scene = sharded_scene(
        make_scene(volume.sphere_volume(volume_n),
                   transfer.gray_ramp(alpha_scale=0.8),
                   pack_dtype=pack_dtype), mesh)
    params = mcm.Params(extinction=40.0, anisotropy=0.3, steps=steps)
    state = place_state(
        mcm.reset(params, resolution, resolution, scene), mesh)
    frame_fn = shard_render_frame(mcm, mesh, state, donate=False)

    state = jax.block_until_ready(
        frame_fn(state, scene, params, jnp.float32(0.1), jnp.int32(1)))
    t0 = time.perf_counter()
    for i in range(frames):
        state = frame_fn(state, scene, params,
                         jnp.float32(0.2 + 0.001 * i), jnp.int32(i + 2))
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    return resolution * resolution * steps * frames / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--volume", type=int, default=128)
    ap.add_argument("--exact", action="store_true",
                    help="float32 tables instead of bf16")
    args = ap.parse_args()

    pack_dtype = None if args.exact else jnp.bfloat16
    n = len(jax.devices())
    counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= n]
    results = []
    base = None
    for d in counts:
        rate = bench_mesh(d, args.resolution, args.steps, args.frames,
                          args.volume, pack_dtype)
        if base is None:
            base = rate
        eff = rate / (base * d)
        results.append({"devices": d, "events_per_s": round(rate),
                        "efficiency": round(eff, 4)})
        print(json.dumps(results[-1]))
    print(json.dumps({"metric": "mcm_scaling", "results": results}))


if __name__ == "__main__":
    main()
