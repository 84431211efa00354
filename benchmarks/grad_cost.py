"""Component-cost profile of the MCM *backward* pass.

Applies the event_cost.py ablation discipline to the grad graph: times
value_and_grad of the image-MSE loss through diff_mc with individual
backward components removed, so the measured ns/event decomposes into

- fwd-in-grad        — the primal recompute (t_fwd of the same graph)
- scatter path       — the take-transpose: one-hot expand + wide-row
                       scatter-add
- select/lerp transposes — native two-stage transpose of the cell select +
                       trilinear chain vs the fused analytic outer product
                       (Scene.fused_vjp: sampling._select_trilerp)
- TF chain           — the transfer-function bilinear lookup's backward
                       w.r.t. its input value (d color / d value)
- score chain        — the likelihood-ratio logw bookkeeping's backward
                       (score_floor >= 1 freezes it; values unchanged)
- residual traffic + loop logic — the remainder

Variants (all value bit-identical except analytic-tf, which replaces the
TF with an analytic curve to DELETE the TF gather + its transpose):

  full         plain VJP
  fused        Scene.fused_vjp=True
  scorefrozen  score_floor=1.0
  antf         analytic TF
  fused+scorefrozen, fused+antf, fused+antf+scorefrozen  (triangulation)
  gradenv      d loss / d environment texel only (no table cotangent at
               all: isolates loop/residual overhead + deposit chain)

Usage: python benchmarks/grad_cost.py [--vol 256]
       [--res 512] [--frames 4] [--iters 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp


def bench(res: int, vol_n: int, steps: int, frames: int, iters: int,
          fused: bool, score_frozen: bool, analytic_tf: bool,
          grad_env: bool = False) -> dict:
    from vpt_jax import sampling, transfer, volume
    from vpt_jax.renderers import diff_mc, make_scene
    from vpt_jax.renderers import mcm as mcm_mod

    vol = volume.sphere_volume(vol_n)
    tf = transfer.gray_ramp(alpha_scale=0.8)
    template = make_scene(vol, tf, pack=False)
    params = mcm_mod.Params(extinction=40.0, anisotropy=0.3, steps=steps)
    target = jnp.zeros((res, res, 3), jnp.float32)
    fold = sampling.scatter_fold_log2(vol_n ** 3, 8, vol_n)
    score_floor = 1.0 if score_frozen else None

    scene_cls = type(template)
    if analytic_tf:
        class AnalyticTF(scene_cls):
            def sample_color(self, position):
                v = self.sample_volume_rg(position)[..., 0:1]
                return jnp.concatenate([v, v, v, v * 0.8], axis=-1)
        jax.tree_util.register_pytree_node_class(AnalyticTF)
        scene_cls = AnalyticTF

    def loss_fn(voxels, env):
        sc = scene_cls(**{
            f.name: getattr(template, f.name)
            for f in dataclasses.fields(template)})
        sc = dataclasses.replace(
            sc, volume=voxels, environment=env,
            volume_packed=sampling.pack_corner_volume(voxels, fold),
            transfer_packed=(None if analytic_tf else
                             sampling.pack_corner_texture2d(
                                 template.transfer)),
            fused_vjp=fused)
        img = diff_mc.mcm_expected_image(sc, params, res, res, frames,
                                         seed0=0.3, score_floor=score_floor)
        return jnp.mean((img - target) ** 2)

    argnum = 1 if grad_env else 0
    fwd = jax.jit(loss_fn)
    bwd = jax.jit(jax.value_and_grad(loss_fn, argnums=argnum))
    voxels, env = template.volume, template.environment

    def run(fn):
        jax.block_until_ready(fn(voxels, env))   # compile + warm
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(voxels, env)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / iters

    t_fwd = run(fwd)
    t_bwd = run(bwd)
    events = res * res * steps * frames
    name = "+".join(
        [n for n, on in (("fused", fused), ("scorefrozen", score_frozen),
                         ("antf", analytic_tf), ("gradenv", grad_env))
         if on]) or "full"
    return {
        "variant": name,
        "config": f"{res}x{res}/{vol_n}^3/steps{steps}x{frames}f"
                  f"(fold {1 << fold})",
        "grad_events_per_s": round(events / t_bwd),
        "forward_events_per_s": round(events / t_fwd),
        "bwd_ns_per_event": round(t_bwd / events * 1e9, 1),
        "fwd_ns_per_event": round(t_fwd / events * 1e9, 1),
        "bwd_minus_fwd_ns": round((t_bwd - t_fwd) / events * 1e9, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--vol", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--variants", default="full,fused,scorefrozen,antf,"
                    "fused+scorefrozen,fused+antf,fused+antf+scorefrozen,"
                    "gradenv")
    args = ap.parse_args()
    from vpt_jax.runtime import device

    device.enable_compile_cache()
    device.require_gpu()
    for v in args.variants.split(","):
        parts = set(v.split("+"))
        print(json.dumps(bench(
            args.res, args.vol, args.steps, args.frames, args.iters,
            fused="fused" in parts, score_frozen="scorefrozen" in parts,
            analytic_tf="antf" in parts, grad_env="gradenv" in parts)),
            flush=True)


if __name__ == "__main__":
    main()
