"""BASELINE config 4: MCM over a spatially sharded volume with overlapped
gradient all-reduce (`BASELINE.json configs[4]`: 512^3 volume, 1024^2
image).

The script runs the multi-device program — halo-sharded slabs over the
mesh's ``space`` axis, pixel rows auto-sharded over ``data``, sharded
voxel gradients with halo-plane exchange and per-bucket (overlappable)
collectives (parallel/halo_grad.py) — at structurally identical reduced
shapes on whatever devices exist, and prints the compiled-HLO collective
counts that evidence the communication structure.  Pass ``--full`` for
the config's stated shapes.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/config4_pod512.py

Full scale (512^3, 1024^2), on the cards of one host or with
jax.distributed initialized (parallel/distributed.py):
    python examples/config4_pod512.py --full
"""

from __future__ import annotations

import argparse
import pathlib
import re
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


def count_collectives(compiled) -> dict:
    hlo = compiled.as_text()
    out = {}
    for op in _COLLECTIVES:
        n = len(re.findall(rf"= \S* ?{op}(?:-start)?\(", hlo))
        if n:
            out[op] = n
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="config-4 stated shapes (512^3, 1024^2)")
    ap.add_argument("--spp", type=int, default=32,
                    help="progressive samples/pixel for the forward phase")
    ap.add_argument("--fit-steps", type=int, default=4)
    ap.add_argument("--buckets", type=int, default=4)
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vpt_jax import transfer, volume
    from vpt_jax.parallel import make_mesh
    from vpt_jax.parallel.distributed import initialize, topology_summary
    from vpt_jax.parallel.halo import sharded_render_frame
    from vpt_jax.parallel.halo_grad import (
        make_sharded_grad, place_slabs, rehalo,
    )
    from vpt_jax.parallel.shard import place_state
    from vpt_jax.renderers import make_scene, mcm

    initialize()
    print(topology_summary())

    n = len(jax.devices())
    num_slabs = max(s for s in (1, 2, 4, 8) if n % s == 0 and s <= n)
    mesh = make_mesh(n, space=num_slabs)
    print(f"mesh: {dict(mesh.shape)}  (slabs={num_slabs})")

    if args.full:
        vol_n, res = 512, 1024
    else:
        vol_n, res = 64, 128
    print(f"volume {vol_n}^3, image {res}^2")

    scene = make_scene(volume.blobs_volume(vol_n, seed=3),
                       transfer.gray_ramp(alpha_scale=0.9))
    params = mcm.Params(extinction=30.0, anisotropy=0.2, steps=8)

    # -- phase 1: progressive accumulation to --spp over the sharded volume
    state = place_state(mcm.reset(params, res, res, scene), mesh)
    frame_fn, slabs_fwd = sharded_render_frame(
        mcm, mesh, scene, num_slabs, state)
    t0 = time.perf_counter()
    frames = 0
    while True:
        frames += 1
        state = frame_fn(state, slabs_fwd, params, jnp.float32(0.1 * frames),
                         jnp.int32(frames))
        if frames % 8 == 0:
            spp = float(np.asarray(state["samples"]).mean())
            if spp >= args.spp:
                break
    dt = time.perf_counter() - t0
    ev = res * res * params.steps * frames
    print(f"forward: {spp:.1f} spp in {frames} frames, "
          f"{dt:.1f}s, {ev / dt / 1e6:.1f}M events/s")
    # close over params: the Params pytree's asarray-coercing flatten
    # breaks .lower()'s ArgInfo tree mapping (same as collectives.py)
    fwd_coll = count_collectives(jax.jit(
        lambda st, sl, seed, fr: frame_fn(st, sl, params, seed, fr)
    ).lower(state, slabs_fwd, jnp.float32(0.1), jnp.int32(1)).compile())
    print("forward-frame collectives:", fwd_coll)

    # -- phase 2: sharded voxel-gradient fit (perturbed volume -> target) --
    target = jnp.asarray(np.asarray(state["radiance"]), jnp.float32)
    init = jnp.clip(scene.volume * 0.6, 0.0, 1.0)   # dimmed start
    grad_frames = 2
    grad_fn = make_sharded_grad(mesh, scene, params, res, res, grad_frames,
                                num_slabs, num_buckets=args.buckets)
    slabs = place_slabs(init, mesh, num_slabs)
    grad_coll = count_collectives(
        grad_fn.lower(slabs, target, jnp.float32(0.5)).compile())
    print(f"grad-step collectives ({args.buckets} buckets):", grad_coll)

    # fixed seed: a deterministic objective whose SGD descent is checkable
    # (per-step fresh seeds — fit_mc's default — decorrelate estimator
    # noise but make single-step loss comparisons stochastic)
    lr = 1.0
    losses = []
    t0 = time.perf_counter()
    for i in range(args.fit_steps):
        loss, g = grad_fn(slabs, target, jnp.float32(0.5))
        bodies = jnp.clip(slabs[:, :-1] - lr * g, 0.0, 1.0)
        slabs = rehalo(bodies, mesh)
        losses.append(float(loss))
    dt = time.perf_counter() - t0
    print(f"fit: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({args.fit_steps} steps, {dt / args.fit_steps:.2f}s/step)")
    assert losses[-1] < losses[0], "loss must descend"
    print("ok")


if __name__ == "__main__":
    main()
