"""Inverse rendering demo: reconstruct a volume from three orbit views.

    python examples/inverse_demo.py
"""

import argparse
import sys

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args()
    import jax.numpy as jnp
    import numpy as np

    from vpt_jax import transfer, volume
    from vpt_jax.renderers import eam
    from vpt_jax.runtime.animators import OrbitCameraAnimator
    from vpt_jax.scene import CameraState, default_camera
    from vpt_jax.train import fit, render_eam

    tf = transfer.gray_ramp(alpha_scale=1.0)
    params = eam.Params(slices=32, random=False)
    truth = volume.blobs_volume(args.grid, seed=9)

    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    views, targets = [], []
    for yaw in np.linspace(0, 2 * np.pi, 4)[:-1]:
        orbit.yaw = float(yaw)
        orbit._update_camera()
        cs = CameraState.from_nodes(cam)
        mats = (cs.mvp_inverse, cs.model_view, cs.projection)
        views.append(mats)
        targets.append(render_eam(truth.data, tf, mats, params,
                                  jnp.float32(0.0), 64, 64))

    init = jnp.full((args.grid,) * 3 + (1,), 0.2, jnp.float32)
    vol, _, losses = fit(targets, views, init, tf, steps=args.steps,
                         learning_rate=0.1, params=params, verbose=True)
    err = float(jnp.mean(jnp.abs(vol - truth.data)))
    print(f"final loss {losses[-1]:.2e}; mean voxel error {err:.4f}")


if __name__ == "__main__":
    sys.exit(main())
