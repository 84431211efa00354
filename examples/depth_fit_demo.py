"""Inverse isosurface rendering: recover geometry from a depth image.

BASELINE config 1 end-to-end: render a *target depth map* of a
ground-truth volume with the differentiable ISO renderer, then optimize a
perturbed volume so its isosurface reproduces that depth — gradients flow
through the soft first-crossing distribution (renderers/diff_iso.py).

Runs in about a minute on the CPU (JAX_PLATFORMS=cpu):
    python examples/depth_fit_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from vpt_jax import transfer, volume  # noqa: E402
from vpt_jax.renderers import diff_iso, make_scene  # noqa: E402


def main():
    h = w = 48
    params = diff_iso.Params(isovalue=0.4, tau=0.03, steps=64)

    truth = volume.sphere_volume(24).data
    scene = make_scene(truth, transfer.gray_ramp(alpha_scale=1.0),
                       pack=False)
    target = diff_iso.render(scene, params, h, w)["depth"]

    # start from a blurred/shrunken guess
    guess = jnp.asarray(np.asarray(volume.sphere_volume(24).data) * 0.6)

    loss_fn = jax.jit(lambda v: diff_iso.depth_loss(
        v, scene, params, target, h, w))
    grad_fn = jax.jit(jax.grad(lambda v: diff_iso.depth_loss(
        v, scene, params, target, h, w)))

    opt = optax.adam(0.05)
    opt_state = opt.init(guess)
    l0 = float(loss_fn(guess))
    for i in range(60):
        g = grad_fn(guess)
        updates, opt_state = opt.update(g, opt_state, guess)
        guess = jnp.clip(optax.apply_updates(guess, updates), 0.0, 1.0)
        if i % 10 == 0:
            print(f"step {i:3d}  depth MSE {float(loss_fn(guess)):.6f}")
    l1 = float(loss_fn(guess))
    print(f"depth MSE: {l0:.6f} -> {l1:.6f}  ({l0 / max(l1, 1e-12):.1f}x)")
    assert l1 < l0 * 0.2, "optimization should reduce depth error >5x"


if __name__ == "__main__":
    main()
