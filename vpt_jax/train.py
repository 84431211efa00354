"""Inverse rendering: fit voxel densities / transfer-function parameters.

The reference is a forward renderer only; differentiability is this
framework's extension (BASELINE.json north star): every sampler is built from
gathers and elementwise math whose VJPs are scatter-adds, so image-space
losses backpropagate to the voxel grid, the TF texture, or the Gaussian-bump
parameters.  EAM (and the tone mappers) are directly AD-able; the
Monte-Carlo renderers get expected-value estimators (renderers/diff_mc.py).

``make_train_step`` builds one jitted SPMD step: forward render → loss →
grads → optax update.  Under a mesh, pixels shard over ``data`` and the
volume over ``space``; XLA's partitioner inserts the psum for the gradient
all-reduce (the overlapped-collective analog of bucketed NCCL all-reduce).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import optax

from . import transfer as transfer_mod
from .renderers import eam
from .renderers.base import Scene


def render_eam(volume_data, tf_texture, camera_matrices, params: eam.Params,
               seed, height: int, width: int):
    """Differentiable single-frame EAM forward pass."""
    mvp_inv, model_view, projection = camera_matrices
    scene = Scene(volume=volume_data, transfer=tf_texture,
                  environment=jnp.ones((1, 1, 4), jnp.float32),
                  mvp_inverse=mvp_inv, model_view=model_view,
                  projection=projection)
    return eam.generate(scene, params, seed, height, width)


@dataclasses.dataclass
class FitState:
    volume_data: Any
    tf_texture: Any
    opt_state: Any
    step: int = 0


def make_train_step(optimizer: optax.GradientTransformation,
                    params: Optional[eam.Params] = None,
                    height: int = 256, width: int = 256,
                    fit_volume: bool = True, fit_tf: bool = False,
                    loss_fn: Callable = None):
    """Build ``step(volume, tf, opt_state, camera_matrices, target, seed) ->
    (loss, volume, tf, opt_state)`` for EAM inverse rendering.

    ``target``: (H, W, 4) reference image(s).  Gradients flow to the voxel
    grid and/or TF texture per the fit_* flags; the other input passes
    through untouched (stop-gradient semantics via zero masking).
    """
    params = params or eam.Params(random=False)

    if loss_fn is None:
        def loss_fn(pred, target):
            return jnp.mean((pred[..., :3] - target[..., :3]) ** 2)

    def compute_loss(fit_leaves, static_leaves, camera_matrices, target,
                     seed):
        volume_data = fit_leaves.get("volume", static_leaves.get("volume"))
        tf_texture = fit_leaves.get("tf", static_leaves.get("tf"))
        pred = render_eam(volume_data, tf_texture, camera_matrices, params,
                          seed, height, width)
        return loss_fn(pred, target)

    def step(volume_data, tf_texture, opt_state, camera_matrices, target,
             seed):
        fit_leaves = {}
        static_leaves = {}
        (fit_leaves if fit_volume else static_leaves)["volume"] = volume_data
        (fit_leaves if fit_tf else static_leaves)["tf"] = tf_texture

        loss, grads = jax.value_and_grad(compute_loss)(
            fit_leaves, static_leaves, camera_matrices, target, seed)
        updates, opt_state = optimizer.update(grads, opt_state, fit_leaves)
        new_fit = optax.apply_updates(fit_leaves, updates)
        new_volume = new_fit.get("volume", volume_data)
        new_tf = new_fit.get("tf", tf_texture)
        if fit_volume:
            new_volume = jnp.clip(new_volume, 0.0, 1.0)
        return loss, new_volume, new_tf, opt_state

    return step


#: default estimator extinctions fit_mc uses when no Params are passed —
#: the single source for callers that need the fit's optical depth after
#: the fact (cli.py's --inpaint visibility mask reads it from here)
MC_FIT_EXTINCTION = {"mcm": 10.0, "mcs": 5.0}


def make_mc_fit(target, scene_template, renderer: str = "mcm",
                params=None, frames: int = 64, learning_rate: float = 0.02):
    """The Monte-Carlo fit's pieces: ``(loss_fn, step, optimizer)``.

    ``loss_fn(leaves, seed0)`` is the image MSE of the *expected* MC
    radiance against ``target`` for the ``{"volume": ..., "tf": ...}``
    leaves being fitted, through the detached-decision ratio-weight
    estimators of :mod:`vpt_jax.renderers.diff_mc` (score-function +
    pathwise gradients; same RNG streams as the analog renderers).
    ``step(leaves, opt_state, seed0) -> (loss, grads, leaves, opt_state)``
    is one jitted Adam step; fitted leaves are clipped to [0, 1]."""
    import dataclasses as _dc

    from .renderers import diff_mc
    from .renderers import mcm as mcm_mod
    from .renderers import mcs as mcs_mod

    if renderer == "mcm":
        params = params or mcm_mod.Params(
            extinction=MC_FIT_EXTINCTION["mcm"], steps=16)
        expected = diff_mc.mcm_expected_image
    elif renderer == "mcs":
        params = params or mcs_mod.Params(
            extinction=MC_FIT_EXTINCTION["mcs"])
        expected = diff_mc.mcs_expected_image
    else:
        raise ValueError("fit_mc supports 'mcm' and 'mcs'")

    target = jnp.asarray(target, jnp.float32)
    height, width = target.shape[:2]
    optimizer = optax.adam(learning_rate)

    def loss_fn(leaves, seed0):
        from . import sampling

        # corner-pack inside the differentiated graph: 1 gather/event
        # forward and 1 scatter-add/event backward instead of 8 of each;
        # f32 packing is bit-identical to the unpacked oracle.  Big tables
        # fold to wide rows (sampling.scatter_fold_log2) for the backward
        # scatter.
        vol = leaves.get("volume", scene_template.volume)
        tf_tex = leaves.get("tf", scene_template.transfer)
        fold = sampling.scatter_fold_log2(
            vol.shape[0] * vol.shape[1] * vol.shape[2], 8 * vol.shape[3],
            vol.shape[2])
        sc = _dc.replace(
            scene_template,
            volume=vol,
            transfer=tf_tex,
            volume_packed=sampling.pack_corner_volume(vol, fold),
            transfer_packed=sampling.pack_corner_texture2d(tf_tex),
            transfer_mxu=None)
        img = expected(sc, params, height, width, frames, seed0=seed0)
        pred = img[..., :3] if img.shape[-1] >= 3 else img
        return jnp.mean((pred - target[..., :3]) ** 2)

    @jax.jit
    def step(leaves, opt_state, seed0):
        loss, grads = jax.value_and_grad(loss_fn)(leaves, seed0)
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        leaves = optax.apply_updates(leaves, updates)
        leaves = {k: jnp.clip(v, 0.0, 1.0) for k, v in leaves.items()}
        return loss, grads, leaves, opt_state

    return loss_fn, step, optimizer


def fit_mc(target, scene_template, init_volume=None, init_tf=None,
           renderer: str = "mcm", params=None, frames: int = 64,
           steps: int = 50, learning_rate: float = 0.02,
           verbose: bool = False):
    """Inverse rendering through the Monte-Carlo estimators (BASELINE
    config 3: voxel-density gradients through MCM).

    Optimizes the voxel grid and/or TF texture so the *expected* MC
    radiance matches ``target`` (:func:`make_mc_fit`).
    Returns (volume, tf, losses)."""
    _, step, optimizer = make_mc_fit(target, scene_template, renderer,
                                     params, frames, learning_rate)
    leaves = {}
    if init_volume is not None:
        leaves["volume"] = jnp.asarray(init_volume, jnp.float32)
    if init_tf is not None:
        leaves["tf"] = jnp.asarray(init_tf, jnp.float32)
    if not leaves:
        raise ValueError("nothing to fit: pass init_volume and/or init_tf")
    opt_state = optimizer.init(leaves)

    losses = []
    for i in range(steps):
        # fresh seed stream per step: decorrelates estimator noise
        loss, _, leaves, opt_state = step(leaves, opt_state,
                                          jnp.float32(0.1 + 0.013 * i))
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return leaves.get("volume"), leaves.get("tf"), losses


def fit(target, camera_matrices, init_volume, init_tf,
        steps: int = 100, learning_rate: float = 0.05,
        params: Optional[eam.Params] = None,
        fit_volume: bool = True, fit_tf: bool = False,
        verbose: bool = False):
    """Convenience driver: Adam-optimize a volume (and/or TF) against target
    EAM renderings.  Returns (volume, tf, losses).

    Multi-view: pass ``target`` as a list of images and
    ``camera_matrices`` as a matching list of (mvp_inv, model_view, proj)
    tuples — the loss is averaged over views (single-view reconstruction is
    ill-posed along the view axis; a handful of orbit views resolves it)."""
    if not isinstance(target, (list, tuple)):
        target = [target]
        camera_matrices = [camera_matrices]
    targets = [jnp.asarray(t, jnp.float32) for t in target]
    height, width = targets[0].shape[:2]
    mats = (jnp.stack([m[0] for m in camera_matrices]),
            jnp.stack([m[1] for m in camera_matrices]),
            jnp.stack([m[2] for m in camera_matrices]))
    targets = jnp.stack(targets)

    optimizer = optax.adam(learning_rate)
    params = params or eam.Params(random=False)

    def multiview_loss(fit_leaves, static_leaves, mats, targets, seed):
        volume_data = fit_leaves.get("volume", static_leaves.get("volume"))
        tf_texture = fit_leaves.get("tf", static_leaves.get("tf"))

        def one(view):
            mvp_inv, mv, proj, tgt = view
            pred = render_eam(volume_data, tf_texture, (mvp_inv, mv, proj),
                              params, seed, height, width)
            return jnp.mean((pred[..., :3] - tgt[..., :3]) ** 2)

        losses = jax.vmap(one)((mats[0], mats[1], mats[2], targets))
        return jnp.mean(losses)

    @jax.jit
    def step(volume_data, tf_texture, opt_state, seed):
        fit_leaves = {}
        static_leaves = {}
        (fit_leaves if fit_volume else static_leaves)["volume"] = volume_data
        (fit_leaves if fit_tf else static_leaves)["tf"] = tf_texture
        loss, grads = jax.value_and_grad(multiview_loss)(
            fit_leaves, static_leaves, mats, targets, seed)
        updates, opt_state = optimizer.update(grads, opt_state, fit_leaves)
        new_fit = optax.apply_updates(fit_leaves, updates)
        new_volume = new_fit.get("volume", volume_data)
        new_tf = new_fit.get("tf", tf_texture)
        if fit_volume:
            new_volume = jnp.clip(new_volume, 0.0, 1.0)
        return loss, new_volume, new_tf, opt_state

    fit_leaves = {}
    if fit_volume:
        fit_leaves["volume"] = init_volume
    if fit_tf:
        fit_leaves["tf"] = init_tf
    opt_state = optimizer.init(fit_leaves)

    volume_data, tf_texture = init_volume, init_tf
    losses = []
    for i in range(steps):
        loss, volume_data, tf_texture, opt_state = step(
            volume_data, tf_texture, opt_state, jnp.float32(0.0))
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return volume_data, tf_texture, losses
