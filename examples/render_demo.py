"""Render every renderer on a synthetic scene and write a montage.

    python examples/render_demo.py [--out demo.png]
"""

import argparse
import sys

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="demo.png")
    ap.add_argument("--resolution", type=int, default=192)
    args = ap.parse_args()

    from vpt_jax import tonemap, transfer, volume
    from vpt_jax.io.image import write_png
    from vpt_jax.renderers import factory, make_renderer, make_scene

    scene = make_scene(volume.blobs_volume(48, seed=3),
                       transfer.gray_ramp(alpha_scale=1.0))
    panels = []
    for key in sorted(factory.MODULES):
        spp = 32 if key in ("mcs", "mcm") else 4
        r = make_renderer(key, height=args.resolution, width=args.resolution)
        img = r.render_progressive(scene, frames=spp, seed0=1)
        arr = np.asarray(tonemap.reinhard(img))
        panels.append(np.clip(arr[::-1, :, :3], 0, 1))
        print(f"{key} done")
    sheet = np.concatenate([np.concatenate(panels[:4], axis=1),
                            np.concatenate(panels[4:], axis=1)], axis=0)
    write_png(args.out, sheet, flip=False)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
