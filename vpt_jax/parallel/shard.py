"""Sharded progressive rendering: pixels over ``data``, volume over ``space``.

Replaces the reference's single-GPU fragment-shader dispatch with SPMD over a
device mesh (SURVEY.md §2h, items 1-3):
the per-pixel state pytrees shard by image rows, the volume either replicates
or shards by z slabs, and XLA inserts the collectives.  Because every
renderer seeds its per-pixel RNG from pixel coordinates (not from a global
stream), an N-way sharded render is bit-identical to the single-device
render — asserted by tests/test_parallel.py.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..renderers.base import Scene


def volume_sharding(mesh: Mesh, axis: str = "space") -> NamedSharding:
    """Shard a (D, H, W, C) volume by z slabs."""
    return NamedSharding(mesh, P(axis, None, None, None))


def sharded_scene(scene: Scene, mesh: Mesh,
                  shard_volume: bool = False) -> Scene:
    """Place the scene on the mesh: volume sharded over ``space`` (or
    replicated), everything else replicated."""
    rep = NamedSharding(mesh, P())
    vol_sh = volume_sharding(mesh) if shard_volume else rep
    packed_sh = NamedSharding(mesh, P(("space" if shard_volume else None),
                                      None)) \
        if scene.volume_packed is not None else None
    return Scene(
        volume=jax.device_put(scene.volume, vol_sh),
        transfer=jax.device_put(scene.transfer, rep),
        environment=jax.device_put(scene.environment, rep),
        mvp_inverse=jax.device_put(scene.mvp_inverse, rep),
        model_view=jax.device_put(scene.model_view, rep),
        projection=jax.device_put(scene.projection, rep),
        volume_packed=(jax.device_put(scene.volume_packed, packed_sh)
                       if scene.volume_packed is not None else None),
        transfer_packed=(jax.device_put(scene.transfer_packed, rep)
                         if scene.transfer_packed is not None else None),
        transfer_mxu=(jax.device_put(scene.transfer_mxu, rep)
                      if scene.transfer_mxu is not None else None),
        majorant=(jax.device_put(scene.majorant, rep)
                  if scene.majorant is not None else None),
        tracking_packed=(jax.device_put(scene.tracking_packed, rep)
                         if scene.tracking_packed is not None else None),
        filter=scene.filter,
        gather_fold_log2=scene.gather_fold_log2,
    )


def _state_sharding(state, mesh: Mesh):
    """Row-shard the (H, W, ...) pixel leaves of a renderer state pytree;
    everything else (scalars, DOS's (samples, 2) tap table) replicates.
    The pixel height is inferred as the leading dim shared by the largest
    leaves."""
    leaves = jax.tree_util.tree_leaves(state)
    height = max((leaf.shape[0] for leaf in leaves
                  if getattr(leaf, "ndim", 0) >= 2), default=None)

    def leaf_sharding(leaf):
        if getattr(leaf, "ndim", 0) >= 2 and leaf.shape[0] == height:
            return NamedSharding(mesh, P("data", *([None] * (leaf.ndim - 1))))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(leaf_sharding, state)


def place_state(state, mesh: Mesh):
    """Move a renderer state pytree onto the mesh with row sharding."""
    return jax.tree_util.tree_map(
        jax.device_put, state, _state_sharding(state, mesh))


def shard_render_frame(module, mesh: Mesh, state_example,
                       donate: bool = True):
    """jit the renderer's ``render_frame`` with explicit input/output
    shardings: state sharded by pixel rows over ``data``, scene as placed.

    Returns a compiled-on-first-call function
    ``(state, scene, params, seed, frame) -> state`` whose output keeps the
    row sharding, so progressive accumulation never leaves the devices —
    the cross-chip analog of the reference's on-GPU DoubleBuffer swap."""
    st_sh = _state_sharding(state_example, mesh)
    return jax.jit(
        module.render_frame,
        in_shardings=(st_sh, None, None, None, None),
        out_shardings=st_sh,
        donate_argnums=(0,) if donate else (),
    )


def shard_display(module, mesh: Mesh, state_example):
    st_sh = _state_sharding(state_example, mesh)
    img_sh = NamedSharding(mesh, P("data", None, None))
    return jax.jit(module.display, in_shardings=(st_sh, None, None),
                   out_shardings=img_sh)
