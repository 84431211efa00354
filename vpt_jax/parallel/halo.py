"""Spatially sharded volumes: z-slab decomposition with halo planes.

For grids too large to replicate per chip (SURVEY.md §2h item 2), the volume
shards into z slabs across the mesh's ``space`` axis.  Each device holds its
slab plus one halo plane from the +z neighbor, so trilinear reads at the
partition face never need remote taps; arbitrary sample positions (MCM
photons jump anywhere) are handled by *ownership masking*: every device
evaluates the trilinear fetch for the positions whose cell it owns and
contributes zero elsewhere, and a ``psum`` over ``space`` assembles the
exact value.  This generalizes ray handoff — photons crossing slab
boundaries simply change owner on the next event, no explicit migration.

Composition: ``sharded_render_frame(module, mesh, …)`` shard_maps a whole
renderer frame with pixel rows on ``data`` and slabs on ``space``; inside,
a :class:`HaloScene` duck-types the Scene sampler interface, so every
renderer runs unmodified.  Results are bit-identical to the replicated
render (asserted in tests/test_halo.py) up to one caveat: the shard_map
partitioner may reassociate the position math by 1 ulp, and on scenes
where a float comparison sits exactly on that knife edge a discrete MC
branch can flip (measured: 0/256 pixels on the test scene, ~6% of pixels
on a 48² sphere at extinction 30 — same count packed or unpacked, i.e.
the corner-packed slab fast path adds no divergence of its own; packed
vs unpacked sharded frames agree bitwise on every discrete field and to
1 ulp on floats).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..renderers.base import Scene


def shard_volume_with_halo(volume, num_slabs: int):
    """(D, H, W, C) → (S, Ds+1, H, W, C): slab k holds z planes
    [k·Ds, (k+1)·Ds] inclusive — one halo plane from the next slab (the last
    slab replicates its final plane, matching CLAMP_TO_EDGE)."""
    d = volume.shape[0]
    if d % num_slabs != 0:
        raise ValueError(f"depth {d} not divisible by {num_slabs} slabs")
    ds = d // num_slabs
    padded = jnp.concatenate([volume, volume[-1:]], axis=0)  # (D+1, ...)
    slabs = jnp.stack([padded[k * ds:k * ds + ds + 1]
                       for k in range(num_slabs)])
    return slabs


class HaloScene:
    """Scene-alike over a local z slab inside a shard_map body.

    Sampler methods mask to locally owned cells and psum over ``axis``;
    everything else mirrors the replicated Scene.
    """

    # class-level defaults so partially-constructed instances
    # (HaloScene.__new__ in tests, old pickles) keep the original
    # contiguous/collective semantics
    collective = True
    interleave = 1

    def __init__(self, slab, slab_index, num_slabs: int, volume_shape,
                 transfer, environment, mvp_inverse, model_view, projection,
                 axis: str = "space", slab_packed=None, transfer_packed=None,
                 slab_tracking=None, transfer_mxu=None,
                 collective: bool = True, interleave: int = 1):
        self.slab = slab                    # (Ds+1, H, W, C)
        self.slab_index = slab_index
        self.num_slabs = num_slabs
        self.volume_shape = volume_shape    # global (D, H, W, C)
        self.transfer = transfer
        self.environment = environment
        self.mvp_inverse = mvp_inverse
        self.model_view = model_view
        self.projection = projection
        self.axis = axis
        self.majorant = None   # local-majorant tracking: replicated-scene only
        self.slab_packed = slab_packed     # ((Ds+1)·H·W, 8·C) or None
        self.transfer_packed = transfer_packed
        self.transfer_mxu = transfer_mxu   # (TW, 4) or None
        #: cheb-skip: this slab's slice of the GLOBAL tracking table
        #: (chebdist is a global property, so slab tables are literal row
        #: slices of skipgrid.pack_tracking_volume's output) — the mcm/mcs
        #: use_skip branches duck-type on this attribute
        self.tracking_packed = slab_tracking
        #: False = local-only sampling (parallel/resident.py): the caller
        #: guarantees every position is owned by this slab, so the
        #: ownership mask and psum are skipped — the gather+lerp chain is
        #: otherwise identical, keeping resident and halo samples bitwise
        #: comparable
        self.collective = collective
        #: cyclic thin-slab assignment (resident.py's load-balance knob):
        #: the volume splits into interleave·S thin slabs, device c
        #: owning thin slabs {c, c+S, …} each with its own halo plane,
        #: concatenated along z in the local arrays.  interleave=1 is the
        #: contiguous layout.  Balances camera-entry photon pileup at the
        #: cost of ~interleave× more boundary crossings.
        self.interleave = interleave

    # -- trilinear over the local slab with ownership masking --------------
    def _sample(self, position):
        d, h, w, c = self.volume_shape
        zloc, y0, x0, fx, fy, fz, local = self._cell_coords(position)

        if self.slab_packed is not None:
            # corner-packed fast path: one gather per
            # sample from the slab-local corner table — identical rows to
            # the replicated pack_corner_volume table because the slab
            # carries its halo plane and x/y edges clamp like the global
            # volume (shard_volume_with_halo replicates the last z plane).
            # Folded slab tables (differentiable path, sampling.py's fold
            # note) are detected from the static row count.
            return self._trilinear_packed(self.slab_packed, c, zloc, y0,
                                          x0, fx, fy, fz, local)

        x1 = jnp.minimum(x0 + 1, w - 1)
        y1 = jnp.minimum(y0 + 1, h - 1)
        z1 = zloc + 1                       # halo plane, always present

        flat = self.slab.reshape(-1, c)

        def g(x, y, z):
            return jnp.take(flat, (z * h + y) * w + x, axis=0)

        c00 = g(x0, y0, zloc) * (1 - fx) + g(x1, y0, zloc) * fx
        c10 = g(x0, y1, zloc) * (1 - fx) + g(x1, y1, zloc) * fx
        c01 = g(x0, y0, z1) * (1 - fx) + g(x1, y0, z1) * fx
        c11 = g(x0, y1, z1) * (1 - fx) + g(x1, y1, z1) * fx
        val = (c00 * (1 - fy) + c10 * fy) * (1 - fz) \
            + (c01 * (1 - fy) + c11 * fy) * fz
        if not self.collective:
            return val
        val = jnp.where(local[..., None], val, 0.0)
        return lax.psum(val, self.axis)

    def _trilinear_packed(self, table, c, zloc, y0, x0, fx, fy, fz, local):
        """Ownership-masked psum trilinear over any slab-local corner
        table (the volume table or the cheb-skip tracking table)."""
        from .. import sampling

        d, h, w = self.volume_shape[:3]
        # total_rows derives from the slab that produced the tables (not
        # the global shape) so a halo-depth mismatch raises in
        # gather_packed_corners instead of mis-detecting the fold
        sd, sh, sw = self.slab.shape[:3]
        exp_sd = self.interleave \
            * (d // (self.interleave * self.num_slabs) + 1)
        assert (sd, sh, sw) == (exp_sd, h, w), \
            f"slab shape {self.slab.shape} != expected ({exp_sd},{h},{w})"
        rows = sampling.gather_packed_corners(
            table, (zloc * h + y0) * w + x0, sd * sh * sw, c)
        cx = rows[..., 0::2, :] * (1 - fx)[..., None] \
            + rows[..., 1::2, :] * fx[..., None]
        cy = cx[..., 0::2, :] * (1 - fy)[..., None] \
            + cx[..., 1::2, :] * fy[..., None]
        val = cy[..., 0, :] * (1 - fz) + cy[..., 1, :] * fz
        if not self.collective:
            return val
        val = jnp.where(local[..., None], val, 0.0)
        return lax.psum(val, self.axis)

    def _cell_coords(self, position):
        """(zloc, y0, x0, fx, fy, fz, local) for ``position`` — the
        slab-local trilinear cell addressing shared by the samplers.

        With ``interleave`` m > 1, zloc addresses the concatenation of
        this device's m thin slabs-with-halo: thin slab t = z0 // thin_ds
        belongs to device t mod S and maps to local planes
        (t div S)·(thin_ds+1) + (z0 − t·thin_ds).  Cells never index
        their slab's halo plane as z0, so the concatenation seams are
        unreachable garbage rows."""
        d, h, w = self.volume_shape[:3]
        dims = jnp.array([w, h, d], jnp.float32)
        u = jnp.clip(position * dims - 0.5, 0.0, dims - 1.0)
        i0 = jnp.floor(u)
        f = u - i0
        i0 = jnp.clip(i0.astype(jnp.int32), 0,
                      jnp.array([w - 1, h - 1, d - 1], jnp.int32))
        x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
        if self.interleave == 1:
            ds = d // self.num_slabs
            owner = jnp.clip(z0 // ds, 0, self.num_slabs - 1)
            local = owner == self.slab_index
            zloc = jnp.clip(z0 - self.slab_index * ds, 0, ds - 1)
        else:
            thin_ds = d // (self.interleave * self.num_slabs)
            thin = z0 // thin_ds
            local = (thin % self.num_slabs) == self.slab_index
            zloc = (thin // self.num_slabs) * (thin_ds + 1) \
                + (z0 - thin * thin_ds)
        return zloc, y0, x0, f[..., 0:1], f[..., 1:2], f[..., 2:3], local

    def sample_color_tracking(self, position):
        """Cheb-skip sampler over the slab-sliced tracking table —
        the spatially sharded twin of Scene.sample_color_tracking (one
        masked gather + psum yields both color and skip distance)."""
        zloc, y0, x0, fx, fy, fz, local = self._cell_coords(position)
        v = self._trilinear_packed(self.tracking_packed, 1, zloc, y0, x0,
                                   fx, fy, fz, local)[..., 0]
        empty = v < -0.5
        # round to the exact stored integer distance, mirroring
        # Scene.sample_color_tracking: ulp-exactness of the recovered cheb
        # is what keeps the sharded hop identical to the replicated one
        cheb = jnp.round(jnp.maximum(-v, 0.0))
        value = jnp.maximum(v, 0.0)
        vs = self._tf_color_1d(value)
        vs = jnp.concatenate(
            [vs[..., :3],
             jnp.where(empty, 0.0, vs[..., 3])[..., None]], axis=-1)
        return vs, cheb

    def _tf_color_1d(self, value):
        """1D TF lookup with the same path priority as the replicated
        Scene (one-hot matmul when present, else the packed/bilinear
        fetch) — a
        different path would quantize alpha differently and flip discrete
        MC branches vs the single-device render."""
        if self.transfer_mxu is not None:
            from .. import sampling

            return sampling.sample_transfer_1d_mxu(self.transfer_mxu, value)
        return self.sample_transfer(
            jnp.stack([value, jnp.zeros_like(value)], axis=-1))

    # -- Scene sampler interface ------------------------------------------
    def sample_volume_rg(self, position):
        s = self._sample(position)
        if s.shape[-1] >= 2:
            return s[..., :2]
        return jnp.concatenate([s, jnp.zeros_like(s)], axis=-1)

    def sample_value(self, position):
        return self._sample(position)[..., 0]

    def sample_transfer(self, uv):
        from .. import sampling

        if self.transfer_packed is not None:
            return sampling.sample_texture2d_packed(
                self.transfer_packed, self.transfer.shape, uv)
        return sampling.sample_texture2d(self.transfer, uv)

    def sample_color(self, position):
        rg = self.sample_volume_rg(position)
        if self.transfer_mxu is not None and self.volume_shape[3] == 1:
            return self._tf_color_1d(rg[..., 0])
        return self.sample_transfer(rg)

    def sample_env(self, direction):
        from .. import sampling

        eh, ew = self.environment.shape[:2]
        if eh == 1 and ew == 1:
            return jnp.broadcast_to(self.environment[0, 0],
                                    direction.shape[:-1] + (4,))
        return sampling.sample_environment(self.environment, direction)

    def value_gradient(self, position, h):
        from .. import sampling

        return sampling.central_value_gradient(self.sample_color, position, h)

    def raw_gradient(self, position, voxel_size):
        from .. import sampling

        return sampling.central_raw_gradient(self.sample_value, position,
                                             voxel_size)


def sharded_render_frame(module, mesh: Mesh, scene: Scene, num_slabs: int,
                         state_example, data_axis: str = "data",
                         space_axis: str = "space"):
    """Build a jitted frame function over a halo-sharded volume.

    Returns ``(frame_fn, slabs)``: call
    ``frame_fn(state, slabs, seed, frame_number)`` with the state row-sharded
    over ``data`` and ``slabs`` sharded over ``space``; output keeps the
    state sharding.  ``module`` is any renderer module whose render_frame
    only touches the scene through the sampler interface."""
    volume_shape = scene.volume.shape
    slabs = shard_volume_with_halo(scene.volume, num_slabs)
    packed = scene.volume_packed is not None
    if packed:
        # per-slab corner tables: the spatially sharded
        # path inherits the one-gather-per-sample packing win; rows match
        # the replicated table bit for bit (halo plane = next z plane,
        # CLAMP_TO_EDGE at the global edges)
        from .. import sampling

        slabs_packed = jax.vmap(sampling.pack_corner_volume)(slabs)
        slabs_packed = slabs_packed.astype(scene.volume_packed.dtype)
        tf_packed = scene.transfer_packed
    tracked = scene.tracking_packed is not None
    if tracked:
        # cheb-skip under spatial sharding: chebdist is a global property,
        # so the per-slab tracking tables are literal row slices of the
        # global table (same z-slab-with-halo layout as the volume)
        d, h, w = volume_shape[:3]
        lanes = scene.tracking_packed.shape[-1]
        t3d = scene.tracking_packed.reshape(d, h, w, lanes)
        slabs_tracking = shard_volume_with_halo(t3d, num_slabs).reshape(
            num_slabs, -1, lanes)

    state_specs = jax.tree_util.tree_map(lambda _: P(), state_example)

    def body(state, slab_block, packed_block, tracking_block, transfer,
             tf_packed, tf_mxu, environment, mvp_inverse, model_view,
             projection, params, seed, frame_number):
        sidx = lax.axis_index(space_axis)
        hscene = HaloScene(
            slab_block[0], sidx, num_slabs, volume_shape, transfer,
            environment, mvp_inverse, model_view, projection,
            axis=space_axis,
            slab_packed=None if packed_block is None else packed_block[0],
            transfer_packed=tf_packed,
            slab_tracking=(None if tracking_block is None
                           else tracking_block[0]),
            transfer_mxu=tf_mxu)
        return module.render_frame(state, hscene, params, seed, frame_number)

    # manual only over `space`: each device's body sees the full pixel grid
    # (auto-partitioned over `data` by XLA) and its own volume slab — so the
    # renderers' iota-derived pixel coordinates stay global.
    mapped = shard_map(
        body, mesh=mesh, axis_names={space_axis},
        in_specs=(state_specs, P(space_axis, None, None, None, None),
                  (P(space_axis, None, None) if packed else P()),
                  (P(space_axis, None, None) if tracked else P()),
                  P(), P(), P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=state_specs,
        check_vma=False,
    )

    @jax.jit
    def frame_fn(state, slabs, params, seed, frame_number):
        if isinstance(slabs, tuple):
            vol_slabs, pk, tk = (tuple(slabs) + (None, None))[:3]
        else:
            vol_slabs, pk, tk = slabs, None, None
        return mapped(state, vol_slabs, pk, tk, scene.transfer,
                      tf_packed if packed else None, scene.transfer_mxu,
                      scene.environment, scene.mvp_inverse,
                      scene.model_view, scene.projection,
                      params, seed, frame_number)

    placed = jax.device_put(
        slabs, NamedSharding(mesh, P(space_axis, None, None, None, None)))
    if packed or tracked:
        table_sh = NamedSharding(mesh, P(space_axis, None, None))
        placed = (placed,
                  jax.device_put(slabs_packed, table_sh) if packed else None,
                  jax.device_put(slabs_tracking, table_sh) if tracked
                  else None)
    return frame_fn, placed
