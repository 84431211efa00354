"""Differentiable spatially sharded rendering (BASELINE config 4).

Voxel-density gradients for volumes too large to replicate per chip: the
volume lives as z slabs over the mesh's ``space`` axis (halo.py), pixel
rows auto-shard over ``data``, and the gradient comes back in slab form —
each device holds exactly its slab's voxel gradients (the ZeRO-style
sharded-optimizer layout for free).  Three collective mechanisms compose:

1. **Forward halo sampling** — the ownership-masked psum of HaloScene
   (one all-reduce over ``space`` in the event-loop body); its transpose
   routes each pixel's cotangent back to the owning slab automatically.
2. **Halo-plane gradient exchange** — slab k's halo plane *is* slab k+1's
   first plane, so after the backward pass its gradient is ppermuted to
   the owner and added there (the last slab's halo replicates its own
   edge plane, CLAMP_TO_EDGE, so its halo gradient folds into its last
   plane).  This is the backward analog of shard_volume_with_halo.
3. **Bucketed data-axis reduction** — the slab splits into z buckets that
   are independent differentiable inputs, so the partitioner emits one
   independent data-axis all-reduce per bucket, overlappable with the
   remaining backward march (same mechanism as overlap.py, applied to the
   sharded layout; HLO evidence in benchmarks/collectives.py).

The in-graph slab corner table folds to wide rows when big enough
(sampling.scatter_fold_log2) for the backward scatter.

Replaces nothing in the reference — VPT is single-GPU (SURVEY.md §2h);
this is the multi-device design the north star asks for
(BASELINE.json configs[4]).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import sampling
from ..renderers.base import Scene
from .halo import HaloScene, shard_volume_with_halo


def _split_slab(slab, num_buckets: int):
    """(Ds+1, H, W, C) haloed slab → [body buckets…, halo plane]: each an
    independent differentiable leaf (one data-axis collective per leaf)."""
    ds = slab.shape[0] - 1
    if ds % num_buckets:
        raise ValueError(f"slab depth {ds} not divisible by {num_buckets}")
    bs = ds // num_buckets
    return [slab[i * bs:(i + 1) * bs] for i in range(num_buckets)] \
        + [slab[ds:ds + 1]]


def _join_slab(parts):
    return jnp.concatenate(list(parts), axis=0)


def make_sharded_grad(mesh: Mesh, scene: Scene, params, height: int,
                      width: int, frames: int, num_slabs: int,
                      expected: Optional[Callable] = None,
                      num_buckets: int = 1,
                      score_floor: Optional[float] = None,
                      space_axis: str = "space"):
    """Build ``grad_fn(slabs, target, seed0) -> (loss, body_grads)`` over a
    halo-sharded volume.

    ``slabs``: (S, Ds+1, H, W, C) from :func:`halo.shard_volume_with_halo`,
    sharded over ``space``; ``body_grads``: (S, Ds, H, W, C) voxel
    gradients in slab-body form with the halo-plane gradients already
    exchanged to their owners (``join`` of the bodies equals the
    replicated-volume gradient).  ``expected`` defaults to the MCM
    expected-image estimator (diff_mc.mcm_expected_image)."""
    if expected is None:
        from ..renderers.diff_mc import mcm_expected_image as expected

    d, h, w, c = scene.volume.shape
    ds = d // num_slabs
    fold = sampling.scatter_fold_log2((ds + 1) * h * w, 8 * c, w)
    volume_shape = scene.volume.shape

    def body(slab_block, transfer, environment, mvp_inverse, model_view,
             projection, target, seed0):
        sidx = lax.axis_index(space_axis)

        def loss_of_parts(parts):
            slab = _join_slab(parts)
            # TF packed too: the packed bilinear lerp order must match the
            # replicated packed scene bit for bit (a 1-ulp difference flips
            # discrete MC branches)
            hscene = HaloScene(
                slab, sidx, num_slabs, volume_shape, transfer, environment,
                mvp_inverse, model_view, projection, axis=space_axis,
                slab_packed=sampling.pack_corner_volume(slab, fold),
                transfer_packed=sampling.pack_corner_texture2d(transfer))
            img = expected(hscene, params, height, width, frames,
                           seed0=seed0, score_floor=score_floor)
            pred = img[..., :3] if img.shape[-1] >= 3 else img
            return jnp.mean((pred - target[..., :3]) ** 2)

        parts = _split_slab(slab_block[0], num_buckets)
        loss, gparts = jax.value_and_grad(loss_of_parts)(parts)
        # Exact 1/S correction for differentiating INSIDE the manual
        # shard_map: every device seeds its own (replicated) loss copy
        # with cotangent 1, and the transpose of the outermost psum sums
        # those S identical seeds — one factor of S total, independent of
        # how many psums the chain traverses (the inner transposes sum
        # genuinely varying per-device cotangents, which is the correct
        # cross-slab reduction).  Validated against dense AD on chained
        # psums and against the replicated EAM gradient
        # (tests/test_halo_grad.py).
        # NOTE: psum's transpose under check_vma=False is a JAX-version-
        # sensitive semantic pinned only empirically — keep
        # test_eam_sharded_grad_matches_replicated as the mandatory guard
        # when bumping JAX.
        g = _join_slab(gparts) / num_slabs        # (Ds+1, H, W, C)

        # halo-plane gradient exchange: slab k's halo plane is slab k+1's
        # first plane; the last slab's halo replicates its own edge plane
        halo_g = g[ds]
        recv = lax.ppermute(halo_g, space_axis,
                            [(k, k + 1) for k in range(num_slabs - 1)])
        body_g = g[:ds].at[0].add(recv)           # slab 0 receives zeros
        is_last = (sidx == num_slabs - 1).astype(halo_g.dtype)
        body_g = body_g.at[ds - 1].add(is_last * halo_g)
        return loss, body_g[None]

    mapped = shard_map(
        body, mesh=mesh, axis_names={space_axis},
        in_specs=(P(space_axis, None, None, None, None),
                  P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(space_axis, None, None, None, None)),
        check_vma=False,
    )

    @jax.jit
    def grad_fn(slabs, target, seed0):
        return mapped(slabs, scene.transfer, scene.environment,
                      scene.mvp_inverse, scene.model_view, scene.projection,
                      target, seed0)

    return grad_fn


def place_slabs(volume, mesh: Mesh, num_slabs: int,
                space_axis: str = "space"):
    """Halo-shard ``volume`` and place the slabs on the mesh."""
    slabs = shard_volume_with_halo(volume, num_slabs)
    return jax.device_put(slabs, NamedSharding(
        mesh, P(space_axis, None, None, None, None)))


def rehalo(body_slabs, mesh: Mesh, space_axis: str = "space"):
    """(S, Ds, H, W, C) slab bodies → (S, Ds+1, H, W, C) haloed slabs:
    each slab fetches its halo plane from the next slab's first plane via
    ppermute (the last slab replicates its own edge plane).  The sharded
    analog of shard_volume_with_halo — lets a train step update slab
    bodies in place and refresh halos without gathering the volume."""
    num_slabs = body_slabs.shape[0]

    def body(block):
        b = block[0]                              # (Ds, H, W, C)
        first = b[0]
        halo = lax.ppermute(first, space_axis,
                            [(k + 1, k) for k in range(num_slabs - 1)])
        sidx = lax.axis_index(space_axis)
        is_last = (sidx == num_slabs - 1).astype(b.dtype)
        halo = halo + is_last * b[-1]             # non-receivers got zeros
        return jnp.concatenate([b, halo[None]], axis=0)[None]

    mapped = shard_map(
        body, mesh=mesh, axis_names={space_axis},
        in_specs=(P(space_axis, None, None, None, None),),
        out_specs=P(space_axis, None, None, None, None),
        check_vma=False,
    )
    return jax.jit(mapped)(body_slabs)
