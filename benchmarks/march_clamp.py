"""March-family empty-space acceleration: the occupied-interval clamp
measured on a sparse 256³ scene.

The march renderers are (slices × gathers)-bound, so the clamp cannot make
a FIXED slice count faster — it concentrates the same slices on the
occupied support (a quadrature refinement).  The honest win is therefore
**equal quality at fewer slices**: on a sparse scene whose occupied box
spans a fraction f of the marched segment, `slices·f` clamped slices give
the exact machine's `slices` sample density.  This benchmark measures, for
EAM and Depth at 512² on a 256³ ball (diameter 0.3):

- ms/frame and image RMSE (vs a 2048-slice exact reference) for the exact
  machine at the 64-slice default,
- the clamped machine at 64 slices (same cost, finer quadrature),
- the clamped machine at the density-matched slice count (the speedup).

Usage: python benchmarks/march_clamp.py [--size 512]
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def build_scenes(n: int):
    from benchmarks.tracking_bench import sparse_ball
    from vpt_jax import transfer
    from vpt_jax.renderers import make_scene

    tf = np.asarray(transfer.gray_ramp(alpha_scale=0.8)).copy()
    tf[:, :8, 3] = 0.0                       # exactly-empty TF floor
    vol = sparse_ball(n)
    kw = dict(pack_dtype=jnp.bfloat16, tf_mxu=True)
    exact = make_scene(vol, jnp.asarray(tf), **kw)
    clamp = make_scene(vol, jnp.asarray(tf), march_clamp=True, **kw)
    assert clamp.occupied_aabb is not None
    return exact, clamp


def run(module, scene, params, size: int, frames: int, seed0: float = 0.11):
    # the scene is a jit ARGUMENT: closing over it would embed the 256³
    # corner table in the program as a constant
    fn = jax.jit(lambda sc, s: module.generate(
        sc, params, jnp.float32(s), size, size))
    jax.block_until_ready(fn(scene, seed0))  # compile + warm
    t0 = time.perf_counter()
    for i in range(frames):
        img = fn(scene, seed0 + 0.001 * i)
    jax.block_until_ready(img)
    ms = (time.perf_counter() - t0) / frames * 1e3
    out = np.asarray(img)
    return out, ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--vol", type=int, default=256)
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vpt_jax.renderers import depth, eam, iso
    from vpt_jax.runtime import device

    device.enable_compile_cache()
    device.require_gpu()
    exact, clamp = build_scenes(args.vol)
    box = np.asarray(clamp.occupied_aabb)
    span = float((box[1] - box[0]).max())
    matched = max(int(np.ceil(64 * span)), 1)
    matched_iso = max(int(np.ceil(50 * span)), 1)
    print(f"# occupied box spans {span:.3f} of the cube; "
          f"density-matched slices = {matched} (iso: {matched_iso})",
          file=sys.stderr)

    for name, module, mk, base in (
            ("eam", eam, lambda s: eam.Params(extinction=80.0, slices=s,
                                              random=False), 64),
            ("depth", depth, lambda s: depth.Params(extinction=200.0,
                                                    slices=s, threshold=0.1,
                                                    random=False), 64),
            # ISO joins the clamp through the isovalue>0 guard; its
            # default budget is 50 steps
            ("iso", iso, lambda s: iso.Params(isovalue=0.3, steps=s), 50)):
        ref, _ = run(module, exact, mk(2048), args.size, 1)
        dm = matched_iso if name == "iso" else matched
        rows = []
        for label, scene, slices in (
                (f"exact/{base}", exact, base),
                (f"clamp/{base}", clamp, base),
                (f"clamp/{dm}", clamp, dm)):
            img, ms = run(module, scene, mk(slices), args.size, args.frames)
            a, b = img, ref
            if name == "iso":
                # ISO's 4th channel is the *segment-relative* ray
                # parameter, which reparametrizes under the clamp; the
                # absolute quantity is the hit position (xyz)
                a, b = img[..., :3], ref[..., :3]
            rmse = float(np.sqrt(np.mean(
                (a.astype(np.float64) - b.astype(np.float64)) ** 2)))
            rows.append({"renderer": name, "config": label,
                         "ms_per_frame": round(ms, 2),
                         "rmse_vs_ref": round(rmse, 5)})
        for r in rows:
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
