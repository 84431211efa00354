"""Multi-device demo: pixel-sharded MCM + halo-sharded volume.

Runs on the cards of one host or a virtual CPU mesh:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/distributed_demo.py
"""

import argparse
import sys

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))



def main():
    ap = argparse.ArgumentParser()
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vpt_jax import transfer, volume
    from vpt_jax.parallel import make_mesh, sharded_scene
    from vpt_jax.parallel.distributed import initialize, topology_summary
    from vpt_jax.parallel.halo import sharded_render_frame
    from vpt_jax.parallel.shard import place_state, shard_render_frame
    from vpt_jax.renderers import make_scene, mcm

    initialize()  # multi-host when a coordinator is configured
    print(topology_summary())

    n = len(jax.devices())
    space = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n, space=space)
    print("mesh:", dict(mesh.shape))

    scene = make_scene(volume.sphere_volume(32),
                       transfer.gray_ramp(alpha_scale=0.9))
    params = mcm.Params(extinction=20.0, steps=8)

    # 1) replicated volume, pixel-sharded photons
    sc = sharded_scene(scene, mesh)
    state = place_state(mcm.reset(params, 64, 64, sc), mesh)
    frame = shard_render_frame(mcm, mesh, state, donate=False)
    state = frame(state, sc, params, jnp.float32(0.3), jnp.int32(1))
    print("pixel-sharded MCM: samples mean",
          float(np.asarray(state["samples"]).mean()))

    # 2) halo-sharded volume (z slabs over the space axis)
    if space > 1:
        state = place_state(mcm.reset(params, 64, 64, scene), mesh)
        frame_fn, slabs = sharded_render_frame(mcm, mesh, scene, space,
                                               state)
        state = frame_fn(state, slabs, params, jnp.float32(0.3),
                         jnp.int32(1))
        print("halo-sharded MCM: samples mean",
              float(np.asarray(state["samples"]).mean()))


if __name__ == "__main__":
    sys.exit(main())
