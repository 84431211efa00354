"""Compiled-collective accounting for the sharded paths.

What the partitioner emits is the structure of the scaling story: this
script lowers the sharded MCM frame, the sharded+halo MCM frame, and the
bucketed/monolithic gradient train steps on a virtual 8-device CPU mesh
and counts the collective ops in the optimized HLO (all-reduce,
all-gather, reduce-scatter, collective-permute, all-to-all).  It needs
no card; timing the same paths is chip_smoke.py --four-cards and
benchmarks/scaling.py.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python benchmarks/collectives.py
(the script forces the CPU platform itself; results go to stdout as JSON)
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all")


def count_collectives(compiled) -> dict:
    hlo = compiled.as_text()
    counts = {}
    for op in COLLECTIVES + ("gather", "scatter"):
        # count op *instructions* (lines like "%x = ... all-reduce(...");
        # the shape token may be a tuple with spaces, hence the loose .*
        n = len(re.findall(rf"= .* {op}(?:-start)?\(", hlo))
        if n:
            counts[op] = n
    return counts


def mcm_frame(mesh, shard_volume):
    from vpt_jax import transfer, volume
    from vpt_jax.parallel import sharded_scene
    from vpt_jax.parallel.shard import place_state, shard_render_frame
    from vpt_jax.renderers import make_scene, mcm

    scene = make_scene(volume.sphere_volume(16),
                       transfer.gray_ramp(alpha_scale=1.0))
    scene = sharded_scene(scene, mesh, shard_volume=shard_volume)
    params = mcm.Params(extinction=10.0, steps=4)
    state = place_state(mcm.reset(params, 32, 32, scene), mesh)
    frame_fn = shard_render_frame(mcm, mesh, state, donate=False)
    # close over params: the Params pytree's asarray-coercing flatten
    # breaks .lower()'s ArgInfo tree mapping
    lowered = jax.jit(
        lambda st, sc, seed, fr: frame_fn(st, sc, params, seed, fr)
    ).lower(state, scene, jnp.float32(0.5), jnp.int32(1))
    return lowered.compile()


def halo_frame(mesh, packed, tracking=False):
    """MCM over a z-slab halo-sharded volume (parallel/halo.py)."""
    import numpy as np

    from vpt_jax import transfer, volume
    from vpt_jax.parallel.halo import sharded_render_frame
    from vpt_jax.renderers import make_scene, mcm

    tf = transfer.gray_ramp(alpha_scale=1.0)
    if tracking:
        tf = np.asarray(tf).copy()
        tf[:, :8, 3] = 0.0          # exactly-empty floor -> cheb-skip
        tf = jnp.asarray(tf)
    scene = make_scene(volume.sphere_volume(16), tf, pack=packed,
                       tracking="cheb" if tracking else "none")
    params = mcm.Params(extinction=10.0, steps=4)
    state = mcm.reset(params, 32, 32, scene)
    frame_fn, slabs = sharded_render_frame(mcm, mesh, scene, 2, state)
    lowered = jax.jit(
        lambda st, sl, seed, fr: frame_fn(st, sl, params, seed, fr)
    ).lower(state, slabs, jnp.float32(0.5), jnp.int32(1))
    return lowered.compile()


def resident_frame(mesh, packed=True):
    """Resident-photon MCM frame (parallel/resident.py): per-round
    collectives are the row all_to_all plus the two small grant
    all_gathers — count them in the optimized HLO."""
    from vpt_jax import transfer, volume
    from vpt_jax.parallel.resident import (
        resident_render_frame, resident_reset,
    )
    from vpt_jax.renderers import make_scene, mcm

    scene = make_scene(volume.sphere_volume(16),
                       transfer.gray_ramp(alpha_scale=1.0), pack=packed)
    params = mcm.Params(extinction=10.0, steps=4)
    pool = resident_reset(scene, params, 32, 32, mesh, num_slabs=2)
    frame_fn, tables = resident_render_frame(mesh, scene, 2, 32, 32)
    lowered = jax.jit(
        lambda p, t, seed, fr: frame_fn(p, t, params, seed, fr)
    ).lower(pool, tables, jnp.float32(0.5), jnp.int32(1))
    return lowered.compile()


def train_step(mesh, bucketed):
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vpt_jax import transfer, volume
    from vpt_jax.renderers import eam
    from vpt_jax.scene import CameraState, default_camera

    optimizer = optax.adam(1e-2)
    vol = volume.sphere_volume(16).data
    tf = transfer.gray_ramp(alpha_scale=1.0)
    vol = jax.device_put(vol, NamedSharding(mesh, P("space", None, None,
                                                    None)))
    tf = jax.device_put(tf, NamedSharding(mesh, P()))
    target = jax.device_put(
        jnp.zeros((32, 32, 4), jnp.float32),
        NamedSharding(mesh, P("data", None, None)))
    cam = CameraState.from_nodes(default_camera())
    mats = (cam.mvp_inverse, cam.model_view, cam.projection)
    params = eam.Params(slices=16, random=False)

    if bucketed:
        from vpt_jax.parallel.overlap import bucketed_train_step
        from vpt_jax.train import render_eam

        def loss_of_volume(v, seed):
            pred = render_eam(v, tf, mats, params, seed, 32, 32)
            return jnp.mean((pred[..., :3] - target[..., :3]) ** 2)

        step = bucketed_train_step(optimizer, loss_of_volume,
                                   num_buckets=4)
        from vpt_jax.parallel.overlap import split_volume

        opt_state = optimizer.init(split_volume(vol, 4))
        lowered = jax.jit(step).lower(vol, opt_state, jnp.float32(0.0))
    else:
        from vpt_jax.train import make_train_step

        opt_state = optimizer.init({"volume": vol})
        step = make_train_step(optimizer, params=params, height=32,
                               width=32)
        lowered = jax.jit(step).lower(vol, tf, opt_state, mats, target,
                                      jnp.float32(0.0))
    return lowered.compile()


def main():
    from vpt_jax.parallel import make_mesh

    mesh = make_mesh(8, space=2)
    results = {}
    results["mcm_frame_replicated_volume"] = count_collectives(
        mcm_frame(mesh, shard_volume=False))
    results["mcm_frame_z_sharded_volume"] = count_collectives(
        mcm_frame(mesh, shard_volume=True))
    results["mcm_frame_halo_unpacked"] = count_collectives(
        halo_frame(mesh, packed=False))
    results["mcm_frame_halo_packed"] = count_collectives(
        halo_frame(mesh, packed=True))
    results["mcm_frame_halo_packed_cheb_tracking"] = count_collectives(
        halo_frame(mesh, packed=True, tracking=True))
    results["mcm_frame_resident_packed"] = count_collectives(
        resident_frame(mesh, packed=True))
    results["train_step_monolithic"] = count_collectives(
        train_step(mesh, bucketed=False))
    results["train_step_bucketed"] = count_collectives(
        train_step(mesh, bucketed=True))
    print(json.dumps({"mesh": "8 devices (data=4, space=2)",
                      "collective_instruction_counts": results}, indent=2))


if __name__ == "__main__":
    main()
