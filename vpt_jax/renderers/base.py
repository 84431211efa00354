"""Renderer protocol: the reference's four-stage pipeline, made functional.

The reference orchestrates every renderer through
``reset → generate → integrate → render`` over ping-ponged GL framebuffers
(``AbstractRenderer.js:60-92``).  Here each renderer is a set of pure
functions over an explicit state pytree:

- ``reset(params, height, width) -> state``  — clear/seed accumulation
  (replaces the reset draw into the DoubleBuffer)
- ``render_frame(state, scene, params, seed, frame) -> state``  — one
  progressive frame: generate a stochastic sample and fold it into the
  accumulation (replaces generate+integrate+swap; the ping-pong swap becomes
  functional state threading, and jit buffer donation makes it in-place)
- ``display(state, scene, params) -> (H, W, 4)``  — produce the HDR image
  the tone mapper consumes (replaces the render stage)

Parameters are dataclasses whose integer/bool fields (loop trip counts,
feature toggles — the reference's shader-recompile-class knobs) are static
under jit, while float fields (extinction, anisotropy, … — GL uniforms) are
traced, so changing them does not recompile.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from .. import environment as envmod
from ..scene import CameraState


def static_field(**kwargs):
    """Field treated as static (non-traced) under jit — structural knobs."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def params_dataclass(cls):
    """Register a params dataclass as a pytree: float fields are leaves,
    static fields are aux data (hashable, trigger recompilation on change)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    leaf_names = [f.name for f in fields if not f.metadata.get("static")]
    static_names = [f.name for f in fields if f.metadata.get("static")]

    def flatten(obj):
        leaves = tuple(
            jnp.asarray(getattr(obj, n), jnp.float32) for n in leaf_names)
        aux = tuple(getattr(obj, n) for n in static_names)
        return leaves, aux

    def unflatten(aux, leaves):
        kwargs = dict(zip(leaf_names, leaves))
        kwargs.update(dict(zip(static_names, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Scene:
    """Everything a renderer samples: the volume texture, the 2D transfer
    function, the environment map, and the camera matrices.

    ``volume_packed`` / ``transfer_packed`` are optional corner-packed copies
    (see sampling.pack_corner_volume): when present, the sample methods use
    the one-gather-per-event fast path — bit-identical results, one row
    gather in place of eight.  The slow path stays as the
    differentiable/test oracle.
    """

    volume: jnp.ndarray               # (D, H, W, C) float32
    transfer: jnp.ndarray             # (TH, TW, 4) float32
    environment: jnp.ndarray          # (EH, EW, 4) float32
    mvp_inverse: jnp.ndarray          # (4, 4) inverse of P·V·M·center
    model_view: jnp.ndarray           # (4, 4) V·M·center (DOS/ISO extras)
    projection: jnp.ndarray           # (4, 4)
    volume_packed: Any = None         # (D·H·W, 8·C) or None
    transfer_packed: Any = None       # (TH·TW, 16) or None
    transfer_mxu: Any = None          # (TW, 4) one-hot matmul lookup table
    majorant: Any = None              # (N, N, N, 2) [maxalpha, chebdist]
    tracking_packed: Any = None       # (D·H·W, 8) cheb-skip corner table
    occupied_aabb: Any = None         # (2, 3) [lo, hi] march clamp box
    iso_aabb: Any = None              # (2, 3) tighter ISO clamp box
    filter: str = "linear"            # volume filter (static)
    #: alpha floor the iso_aabb was derived at (iso_value_aabb): the box
    #: is valid only for isovalue >= this, enforced in-graph.  Static.
    iso_clamp_min: float = 0.0
    #: serve volume gathers at this fold when volume_packed is stored at a
    #: larger one (two-level fold, sampling.take_rows_twolevel): fast
    #: narrow gathers forward, cliff-free wide scatters backward.  Static.
    gather_fold_log2: Optional[int] = None
    #: fused select+lerp cotangent for the packed volume sampler
    #: (sampling._select_trilerp): one outer-product backward instead of
    #: separate select/lerp transposes, positions treated as detached — the
    #: MC grad estimators' contract (diff_mc stop-gradients every position
    #: input).  Opt-in for fit paths; values are bit-identical.  Static.
    fused_vjp: bool = False

    def tree_flatten(self):
        return (self.volume, self.transfer, self.environment,
                self.mvp_inverse, self.model_view, self.projection,
                self.volume_packed, self.transfer_packed, self.transfer_mxu,
                self.majorant, self.tracking_packed, self.occupied_aabb,
                self.iso_aabb), \
            (self.filter, self.gather_fold_log2, self.fused_vjp,
             self.iso_clamp_min)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, filter=aux[0], gather_fold_log2=aux[1],
                   fused_vjp=aux[2], iso_clamp_min=aux[3])

    # -- samplers (the GLSL sampleVolumeColor / sampleEnvironmentMap) ------
    def sample_volume_rg(self, position):
        """texture(uVolume, p).rg — trilinear (value, grad-mag) pair."""
        from .. import sampling

        if self.volume_packed is not None and self.filter == "linear":
            s = sampling.sample_volume_packed(
                self.volume_packed, self.volume.shape, position,
                gather_fold_log2=self.gather_fold_log2,
                fused_vjp=self.fused_vjp)
            if s.shape[-1] >= 2:
                return s[..., :2]
            return jnp.concatenate([s, jnp.zeros_like(s)], axis=-1)
        return sampling.volume_rg(self.volume, position, self.filter)

    def sample_value(self, position):
        """Raw channel-0 trilinear fetch (LAO's sampleVolume)."""
        from .. import sampling

        if self.volume_packed is not None and self.filter == "linear":
            return sampling.sample_volume_packed(
                self.volume_packed, self.volume.shape, position,
                gather_fold_log2=self.gather_fold_log2,
                fused_vjp=self.fused_vjp)[..., 0]
        return sampling.volume_rg(self.volume, position,
                                  self.filter)[..., 0]

    def sample_transfer(self, uv):
        from .. import sampling

        if self.transfer_packed is not None:
            return sampling.sample_texture2d_packed(
                self.transfer_packed, self.transfer.shape, uv)
        return sampling.sample_texture2d(self.transfer, uv)

    def sample_color(self, position):
        """The shared composite sampler TF(volume(p).rg)
        (MCMRenderer.glsl:85-89 et al.).

        Single-channel volumes sample the TF's y = 0 row, a 1D table —
        with ``transfer_mxu`` the lookup runs as a one-hot matmul
        (sampling.sample_transfer_1d_mxu) instead of a gather."""
        if self.transfer_mxu is not None and self.volume.shape[-1] == 1:
            from .. import sampling

            value = self.sample_volume_rg(position)[..., 0]
            return sampling.sample_transfer_1d_mxu(self.transfer_mxu, value)
        return self.sample_transfer(self.sample_volume_rg(position))

    def sample_color_tracking(self, position):
        """Tracking-renderer sampler over the cheb-skip corner table
        (skipgrid.pack_tracking_volume): one gather yields BOTH the shading
        color and the empty-space Chebyshev distance.

        Returns ``(color, cheb)``: ``color`` is TF(value) with alpha forced
        to 0 inside empty cells (where the repurposed rows carry -chebdist
        instead of corner values), ``cheb`` is the distance in voxels to
        the nearest non-empty cell (0 in non-empty cells)."""
        from .. import sampling

        v = sampling.sample_volume_packed(
            self.tracking_packed, self.volume.shape[:3] + (1,),
            position)[..., 0]
        # empty rows hold a constant -chebdist in all 8 lanes; the 3-level
        # lerp of a constant row is exact in exact arithmetic but may be off
        # by a few ulps in float32 (1-f is inexact), and an ulp-high cheb
        # would let the hop overshoot the provably-empty L∞ ball.  Stored
        # distances are exact integers (≤ CHEB_CAP, exact even in bf16), so
        # rounding recovers them exactly — making the hop both safe and
        # identical between this sampler and the psum-assembled halo twin.
        empty = v < -0.5
        cheb = jnp.round(jnp.maximum(-v, 0.0))
        value = jnp.maximum(v, 0.0)
        if self.transfer_mxu is not None:
            vs = sampling.sample_transfer_1d_mxu(self.transfer_mxu, value)
        else:
            uv = jnp.stack([value, jnp.zeros_like(value)], axis=-1)
            vs = self.sample_transfer(uv)
        vs = jnp.concatenate(
            [vs[..., :3],
             jnp.where(empty, 0.0, vs[..., 3])[..., None]], axis=-1)
        return vs, cheb

    def sample_env(self, direction):
        """Equirect env lookup; 1×1 environments (the reference default)
        skip the gather entirely."""
        from .. import sampling

        eh, ew = self.environment.shape[:2]
        if eh == 1 and ew == 1:
            texel = self.environment[0, 0]
            return jnp.broadcast_to(texel, direction.shape[:-1] + (4,))
        return sampling.sample_environment(self.environment, direction)

    def value_gradient(self, position, h):
        """Central-difference gradient of TF alpha (ISORenderer.glsl:165-177)."""
        from .. import sampling

        return sampling.central_value_gradient(self.sample_color, position, h)

    def raw_gradient(self, position, voxel_size):
        """LAO's negated central difference (LAORenderer.glsl:73-80)."""
        from .. import sampling

        return sampling.central_raw_gradient(self.sample_value, position,
                                             voxel_size)


#: tracking="auto" engages cheb-skip when at least this fraction of voxel
#: cells is TF-empty: below it the skip can't pay for its (tiny) arithmetic
#: overhead or the loss of GLSL-exact RNG streams.
AUTO_TRACKING_MIN_EMPTY = 0.05


def make_scene(volume, transfer, camera: Optional[Any] = None,
               environment=None, volume_transform=None,
               pack: Optional[bool] = None, pack_dtype=None,
               tf_mxu: bool = False,
               tf_srgb: bool = False,
               majorant_grid: Optional[int] = None,
               tracking: str = "none",
               march_clamp: bool = False,
               iso_clamp_min: float = 0.0) -> Scene:
    """Assemble a Scene.  ``volume`` may be a Volume dataclass or raw array;
    ``camera`` a scene-graph Node, a CameraState, or None (default camera).

    ``pack``: precompute corner-packed fast-sampling tables (default: yes
    for volumes up to 256³; the packed copy is 8× the volume).
    ``pack_dtype``: dtype of the packed tables.  float32 (default) matches
    the unpacked oracle bit-for-bit; bfloat16 halves the table bytes at
    8-bit-mantissa table precision — comparable to the reference's own
    R8/SRGB8 GL texture formats.
    ``tf_mxu``: evaluate single-channel sample_color's TF lookup as a
    one-hot matmul instead of a gather.
    Lerp fractions quantize to the table dtype (bf16 ≈ the reference's
    8-bit TF texture coordinates), so it is an opt-in fast path like
    ``pack_dtype=bfloat16``.
    ``majorant_grid``: build an N³ super-voxel majorant grid
    (skipgrid.build_majorant_grid) so the tracking renderers sample free
    paths against each cell's conservative local majorant (with DDA
    boundary hops and multi-cell jumps through exactly-empty space)
    instead of the global extinction.  Distributionally the same
    null-collision estimator, but it consumes a different per-pixel RNG
    stream than the GLSL-exact base machine, so it is opt-in;
    single-channel volumes with dims divisible by N only (silently
    ignored otherwise).
    ``tf_srgb``: run the TF through the reference's SRGB8_ALPHA8 texture
    semantics (8-bit quantize + sRGB→linear decode of the color channels,
    ``transfer.to_gl_texture``) before sampling.  Off by default — this
    framework treats authored TF colors as linear HDR, which keeps
    ``pack=False`` scenes an exact float32 oracle; enable it to match the
    reference's GL pipeline pixel for pixel.
    ``tracking``: empty-space acceleration for the null-collision
    renderers (MCM).  ``"none"`` = the reference's global-majorant machine
    (GLSL-exact per-pixel RNG streams).  ``"cheb"`` = voxel-resolution
    Chebyshev empty-space skipping riding the existing corner gather
    (skipgrid.pack_tracking_volume — no extra per-event cost; different
    RNG stream, same estimator).  ``"grid"`` = the coarse local-majorant
    grid (same as ``majorant_grid=16``; one extra coarse gather/event —
    wins only when the occupied region itself needs sub-global majorants).
    ``"auto"`` = per-scene policy: engage cheb-skip when >5% of cells are
    TF-empty (the skip is free in occupied cells, so empty fraction is the
    whole decision), else the exact global machine.
    ``march_clamp``: opt-in empty-space acceleration for the MARCH
    renderers (EAM/MIP/Depth/ISO): clamp each ray's marched segment to
    the occupied AABB (skipgrid.occupied_aabb — cells outside it are
    provably TF-invisible), concentrating the same slice count on the
    visible support.  Changes sample placement (a quadrature refinement
    of the same integral), so it is opt-in and validated against the
    exact oracle like ``pack_dtype`` (tests/test_march_clamp.py); a
    scene with no TF-empty cells keeps occupied_aabb None and the exact
    path bitwise untouched.  ISO's hit test needs TF alpha ≥ isovalue,
    so the TF-empty box is hit-free for any isovalue > 0; the renderer
    guards the clamp with an in-graph ``isovalue > 0`` select (the
    isovalue is traced), so the box stays safe at every parameter value.
    ``iso_clamp_min``: derive ISO's *tighter* clamp box at this alpha
    floor (skipgrid.iso_value_aabb — cells whose achievable TF alpha
    stays below the floor can produce no hit for isovalue ≥ floor); the
    box engages in-graph only where ``isovalue >= iso_clamp_min``,
    falling back to the march_clamp box / full segment below it."""
    from .. import sampling
    from ..scene import default_camera  # local import to avoid cycle
    from ..volume import Volume

    vol_filter = "linear"
    if isinstance(volume, Volume):
        vol_filter = volume.filter
        volume = volume.data
    if camera is None:
        camera = default_camera()
    if not isinstance(camera, CameraState):
        camera = CameraState.from_nodes(camera, volume_transform)
    if environment is None:
        environment = envmod.white()
    volume = jnp.asarray(volume, jnp.float32)
    transfer = jnp.asarray(transfer, jnp.float32)
    if tf_srgb:
        from ..transfer import to_gl_texture

        transfer = to_gl_texture(transfer, srgb=True, quantize=True)
    if pack is None:
        pack = volume.shape[0] * volume.shape[1] * volume.shape[2] \
            <= 256 ** 3
    if vol_filter != "linear":
        pack = False  # packed tables implement the linear filter only
    volume_packed = transfer_packed = transfer_mxu = None
    if tf_mxu and volume.shape[-1] == 1:
        transfer_mxu = sampling.pack_mxu_transfer(
            transfer, pack_dtype if pack_dtype is not None else jnp.float32)
    if pack:
        volume_packed = sampling.pack_corner_volume(volume)
        transfer_packed = sampling.pack_corner_texture2d(transfer)
        if pack_dtype is not None:
            volume_packed = volume_packed.astype(pack_dtype)
            transfer_packed = transfer_packed.astype(pack_dtype)
    if tracking not in ("none", "cheb", "grid", "auto"):
        raise ValueError(f"unknown tracking mode {tracking!r}")
    if tracking == "cheb" and majorant_grid:
        raise ValueError("tracking='cheb' conflicts with majorant_grid — "
                         "the tracking machines are mutually exclusive")
    if tracking == "grid" and not majorant_grid:
        majorant_grid = 16
    majorant = None
    if majorant_grid:
        from .. import skipgrid

        majorant = skipgrid.build_majorant_grid(volume, transfer,
                                                majorant_grid)
        if majorant is None and tracking == "grid":
            import warnings

            warnings.warn(
                "tracking='grid' requested but the majorant grid is "
                "unsupported for this volume (multi-channel, or dims not "
                "divisible by the grid size) — falling back to the exact "
                "machine", stacklevel=2)
    tracking_packed = None
    if tracking in ("cheb", "auto") and majorant is None \
            and vol_filter == "linear":
        from .. import skipgrid

        # the auto policy's empty-fraction decline happens inside the
        # pack, BEFORE the (cap-iteration) distance transform runs
        tracking_packed = skipgrid.pack_tracking_volume(
            volume, transfer,
            min_empty_fraction=(AUTO_TRACKING_MIN_EMPTY
                                if tracking == "auto" else 0.0))
        if tracking_packed is None and tracking == "cheb":
            import warnings

            warnings.warn(
                "tracking='cheb' requested but the tracking table is "
                "unsupported for this volume (multi-channel, or negative "
                "values) — falling back to the exact machine",
                stacklevel=2)
        if tracking_packed is not None and pack_dtype is not None:
            tracking_packed = tracking_packed.astype(pack_dtype)
    elif tracking == "cheb" and vol_filter != "linear":
        import warnings

        warnings.warn(
            "tracking='cheb' requested but the tracking table implements "
            "the linear filter only (volume filter is "
            f"{vol_filter!r}) — falling back to the exact machine",
            stacklevel=2)
    aabb = None
    if march_clamp:
        from .. import skipgrid

        if volume.shape[-1] != 1 or vol_filter != "linear":
            import warnings

            warnings.warn(
                "march_clamp requested but the occupied-AABB derivation "
                "supports single-channel linear-filter volumes only — "
                "marching the full segment", stacklevel=2)
        else:
            aabb = skipgrid.occupied_aabb(volume, transfer)
    iso_box = None
    if iso_clamp_min > 0.0:
        from .. import skipgrid

        if volume.shape[-1] != 1 or vol_filter != "linear":
            import warnings

            warnings.warn(
                "iso_clamp_min requested but the value-AABB derivation "
                "supports single-channel linear-filter volumes only — "
                "marching the full segment", stacklevel=2)
        else:
            iso_box = skipgrid.iso_value_aabb(volume, transfer,
                                              iso_clamp_min)
    return Scene(
        volume=volume,
        transfer=transfer,
        environment=jnp.asarray(environment, jnp.float32),
        mvp_inverse=camera.mvp_inverse,
        model_view=camera.model_view,
        projection=camera.projection,
        volume_packed=volume_packed,
        transfer_packed=transfer_packed,
        transfer_mxu=transfer_mxu,
        majorant=majorant,
        tracking_packed=tracking_packed,
        occupied_aabb=aabb,
        iso_aabb=iso_box,
        filter=vol_filter,
        iso_clamp_min=float(iso_clamp_min),
    )


def march_interval(scene, ray_from, direction):
    """The ray segment a march renderer samples: the unit-cube slab test,
    optionally clamped to the scene's occupied AABB (``march_clamp`` —
    samples outside the box are provably TF-invisible, so the clamp
    re-concentrates the slice budget on the visible support).  Returns
    (..., 2) = (tnear, tfar), both ≥ 0; tnear ≥ tfar means miss."""
    from .. import sampling

    tb = jnp.maximum(sampling.intersect_cube(ray_from, direction), 0.0)
    aabb = getattr(scene, "occupied_aabb", None)
    if aabb is None:
        return tb
    tbb = jnp.maximum(
        sampling.intersect_box(ray_from, direction, aabb[0], aabb[1]), 0.0)
    # intersect the two intervals (the box may poke out of the cube by
    # the CLAMP_TO_EDGE half-texel; the cube bounds stay authoritative)
    return jnp.stack([jnp.maximum(tb[..., 0], tbb[..., 0]),
                      jnp.minimum(tb[..., 1], tbb[..., 1])], axis=-1)


class Renderer:
    """Object-style wrapper over a renderer module's pure functions, mirroring
    the AbstractRenderer API (reset/render/getTexture) with jit caching and
    accumulation-state donation."""

    #: module providing reset/render_frame/display — set by subclass/factory
    module = None
    Params = None

    def __init__(self, params=None, height: int = 512, width: int = 512):
        self.params = params if params is not None else self.Params()
        self.height = height
        self.width = width
        self.frame_number = 0
        self.state = None
        self._render_frame = jax.jit(self.module.render_frame,
                                     donate_argnums=(0,))
        self._display = jax.jit(self.module.display)

    # -- protocol ----------------------------------------------------------
    def reset(self, scene: Optional[Scene] = None):
        self.frame_number = 0
        self.state = self.module.reset(self.params, self.height, self.width,
                                       scene)
        return self.state

    def render(self, scene: Scene, seed: float):
        """One progressive frame (generate + integrate)."""
        if self.state is None:
            self.reset(scene)
        self.frame_number += 1
        self.state = self._render_frame(
            self.state, scene, self.params, jnp.float32(seed),
            jnp.int32(self.frame_number))
        return self.state

    def display(self, scene: Scene):
        return self._display(self.state, scene, self.params)

    def render_progressive(self, scene: Scene, frames: int, seed0: int = 0):
        """Run ``frames`` progressive iterations and return the HDR image.
        Seeds derive deterministically from the frame index."""
        import numpy as np
        rs = np.random.default_rng(seed0)
        self.reset(scene)
        for _ in range(frames):
            self.render(scene, float(rs.random(dtype=np.float32)))
        return self.display(scene)
