"""MCM — Monte-Carlo multiple scattering via Woodcock/null-collision tracking.

The flagship renderer.  Re-implements the reference MCM kernel
(``src/glsl/renderers/MCMRenderer.glsl``): persistent per-pixel photon state
{position, direction+bounces, transmittance, radiance+samples} — the four
RGBA32F MRT attachments of ``MCMRenderer.js:214-263`` become a pytree of
(H, W, ·) arrays — advanced by ``steps`` null-collision events per
progressive frame (integrate:129-166):

  1. exponential free-path sample, position += dist · direction
  2. classify: out-of-bounds → deposit env radiance; absorption
     (P = 1 − P_null − P_scatter) → deposit black; scattering
     (P = α · max3(rgb), zeroed past the bounce cap) → tint transmittance,
     HG-resample direction; else null collision
  3. deposits fold into a per-pixel running mean
     ``radiance += (r − radiance)/samples`` and re-seed the photon through
     the stochastic unprojection (resetPhoton:70-78)

Vectorized form: the per-pixel divergent state machine becomes a masked
``lax.fori_loop`` over the whole pixel grid — every branch outcome is
computed vectorized and committed with ``where`` selects.  RNG draws follow
the exact GLSL stream: tentative draws are evaluated unconditionally but the
per-pixel uint32 state only advances by the draws the taken branch consumes,
so output matches a sequential per-pixel execution bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .. import rng, sampling
from .base import Scene, params_dataclass, static_field


@params_dataclass
class Params:
    extinction: float = 1.0
    anisotropy: float = 0.0
    blur: float = 0.0
    max_bounces: int = static_field(default=8)
    steps: int = static_field(default=8)


def _photon_reset(state, ndc, scene: Scene, params: Params, inv_res):
    """resetPhoton (MCMRenderer.glsl:70-78): stochastic unproject, clip to
    the cube, clear transmittance/bounces.  Consumes 4 uniforms."""
    state, ray_from, ray_to = sampling.unproject_rand(
        state, ndc, scene.mvp_inverse, inv_res, params.blur)
    direction = ray_to - ray_from
    direction = direction / jnp.sqrt(
        jnp.maximum(jnp.sum(direction ** 2, axis=-1, keepdims=True), 1e-20))
    tb = jnp.maximum(sampling.intersect_cube(ray_from, direction), 0.0)
    position = ray_from + tb[..., 0:1] * direction
    return state, position, direction


def reset(params: Params, height: int, width: int, scene: Scene = None,
          seed=0.0):
    """MCM reset stage (MCMRenderer.glsl:259-275): seed every photon through
    the stochastic unprojection; radiance initializes to 1."""
    assert scene is not None, "MCM reset needs the scene (camera rays)"
    ndc = sampling.pixel_ndc(height, width)
    inv_res = jnp.array([1.0 / width, 1.0 / height], jnp.float32)
    state = rng.seed_pixels(ndc, jnp.float32(seed))
    state, position, direction = _photon_reset(state, ndc, scene, params,
                                               inv_res)
    shape = (height, width)
    state = {
        "position": position,
        "direction": direction,
        "bounces": jnp.zeros(shape, jnp.float32),
        "transmittance": jnp.ones(shape + (3,), jnp.float32),
        "radiance": jnp.ones(shape + (3,), jnp.float32),
        "samples": jnp.zeros(shape, jnp.float32),
    }
    if scene.tracking_packed is not None and scene.majorant is None:
        # cheb-skip carry: Chebyshev empty-space distance at the photon's
        # position, refreshed by each event's gather; 0 = unknown/occupied
        # (conservative — the first event after a reset tracks exactly)
        state["cheb"] = jnp.zeros(shape, jnp.float32)
    return state


def flight_phase(ph, rstate, params: Params, use_skip: bool, cell):
    """The event's volume-independent first half: draw the free-path
    sample and advance the photon (MCMRenderer.glsl:130-131).  Pure arithmetic —
    no volume access — which is what makes the resident-photon machine
    possible (parallel/resident.py): the pending sample position is known
    BEFORE any gather, so boundary-crossing photons can migrate to their
    slab's owner between this phase and :func:`interact_phase`.

    Returns ``(rstate, position)`` with the flight applied.  Exact and
    cheb-skip machines only (the majorant-grid flight needs the coarse
    grid — a volume-resident object — and stays in render_frame)."""
    if use_skip:
        # cheb-skip (skipgrid.pack_tracking_volume): the free flight
        # extends to at least (cheb−1) empty cells — provably
        # collision-free, so extending the exponential sample there is
        # exact by memorylessness.  A hop landing always sits in an
        # empty cell (alpha ≡ 0 → p_absorb = p_scatter = 0), so the
        # standard classification below commits a null collision by
        # itself — the machine differs from the exact one ONLY in the
        # flight distance and the (value|−cheb) tracking sampler.
        rstate, t_exp = rng.exponential(rstate, params.extinction)
        hop = jnp.maximum(ph["cheb"] - 1.0, 0.0) * cell
        dist = jnp.maximum(t_exp, hop)
    else:
        rstate, dist = rng.exponential(rstate, params.extinction)
    return rstate, ph["position"] + dist[..., None] * ph["direction"]


def interact_phase(ph, rstate, position, vs, cheb_new, scene, params: Params,
                   ndc, inv_res, use_skip: bool):
    """The event's second half (MCMRenderer.glsl:135-165): classify the
    collision at ``position`` given the sampled color ``vs`` (and the
    landing cell's cheb distance in skip mode), commit the branch with
    ``where`` selects, and advance the RNG by exactly the draws the taken
    branch consumes.  Shape-agnostic over leading dims — render_frame
    runs it on the (H, W) pixel grid, the resident machine on (K,) photon
    pools."""
    alpha = vs[..., 3]
    p_null = 1.0 - alpha
    capped = ph["bounces"] >= params.max_bounces
    p_scatter = jnp.where(capped, 0.0, alpha * sampling.max3(vs[..., :3]))
    p_absorb = 1.0 - p_null - p_scatter

    rstate, fortune = rng.uniform(rstate)
    oob = jnp.any((position > 1.0) | (position < 0.0), axis=-1)
    interact = ~oob
    absorb = interact & (fortune < p_absorb)
    scatter = interact & (~absorb) & (fortune < p_absorb + p_scatter)
    deposit = oob | absorb

    # radiance deposit: env radiance on escape, black on absorption,
    # Welford-style running mean (glsl:147-157)
    env = scene.sample_env(ph["direction"])
    r_new = jnp.where(oob[..., None],
                      ph["transmittance"] * env[..., :3], 0.0)
    samples = jnp.where(deposit, ph["samples"] + 1.0, ph["samples"])
    radiance = jnp.where(
        deposit[..., None],
        ph["radiance"] + (r_new - ph["radiance"])
        / jnp.maximum(samples, 1.0)[..., None],
        ph["radiance"])

    # tentative branch continuations — state advances only per the
    # draws the taken branch consumes
    rs_reset, pos_reset, dir_reset = _photon_reset(
        rstate, ndc, scene, params, inv_res)
    rs_scat, dir_scat = sampling.henyey_greenstein(
        rstate, params.anisotropy, ph["direction"])

    dmask = deposit[..., None]
    smask = scatter[..., None]
    new_ph = {
        "position": jnp.where(dmask, pos_reset, position),
        "direction": jnp.where(dmask, dir_reset,
                               jnp.where(smask, dir_scat,
                                         ph["direction"])),
        "bounces": jnp.where(deposit, 0.0,
                             jnp.where(scatter, ph["bounces"] + 1.0,
                                       ph["bounces"])),
        "transmittance": jnp.where(
            dmask, 1.0,
            jnp.where(smask, ph["transmittance"] * vs[..., :3],
                      ph["transmittance"])),
        "radiance": radiance,
        "samples": samples,
    }
    if use_skip:
        # cheb at the photon's committed position: the landing cell's
        # (scatter/null stay there, skips land there); 0 after a reset
        # (unknown — the next event tracks exactly, conservatively)
        new_ph["cheb"] = jnp.where(deposit, 0.0, cheb_new)
    elif "cheb" in ph:
        # a tracking-era state resumed against a non-tracking scene
        # (e.g. checkpoint + --tracking none, or the auto policy
        # flipping after a TF edit): thread the stale carry unchanged
        # so the fori_loop pytree structure stays consistent
        new_ph["cheb"] = ph["cheb"]
    new_state = jnp.where(deposit, rs_reset,
                          jnp.where(scatter, rs_scat, rstate))
    return new_ph, new_state


def skip_cell_size(scene):
    """The normalized-unit cell size the cheb hop may safely use: chebdist
    counts cells, cells are 1/N of each axis, so the L∞ hop is bounded by
    the smallest cell dimension (volume_shape: HaloScene duck-type — it
    holds only its slab)."""
    shape3 = getattr(scene, "volume_shape", None)
    d, h, w = (shape3 if shape3 is not None else scene.volume.shape)[:3]
    return min(1.0 / d, 1.0 / h, 1.0 / w)


def render_frame(state, scene: Scene, params: Params, seed, frame_number):
    """One progressive frame = ``steps`` null-collision events per pixel
    (MCMRenderer.glsl:116-171)."""
    height, width = state["position"].shape[:2]
    ndc = sampling.pixel_ndc(height, width)
    mapped = ndc * 0.5 + 0.5
    inv_res = jnp.array([1.0 / width, 1.0 / height], jnp.float32)
    # per-pixel stream: hash(uvec3(bits(mapped.xy), bits(seed))) (glsl:128)
    rstate = rng.seed_pixels(mapped, jnp.asarray(seed, jnp.float32))

    use_majorant = scene.majorant is not None
    use_skip = (not use_majorant and scene.tracking_packed is not None
                and "cheb" in state)
    if use_skip:
        cell = skip_cell_size(scene)

    def event(_, carry):
        ph, rstate = carry
        if not use_majorant:
            rstate, position = flight_phase(ph, rstate, params, use_skip,
                                            cell if use_skip else None)
            if use_skip:
                vs, cheb_new = scene.sample_color_tracking(position)
            else:
                vs, cheb_new = scene.sample_color(position), None
            return interact_phase(ph, rstate, position, vs, cheb_new,
                                  scene, params, ndc, inv_res, use_skip)
        # local-majorant tracking (skipgrid.py): exponential flight vs
        # the current cell's conservative majorant, DDA boundary hop
        # when the tentative collision falls outside the cell (valid by
        # memorylessness), ratio alpha/maxalpha in the classification.
        from .. import skipgrid

        mu, t_bound = skipgrid.flight_step(
            scene.majorant, ph["position"], ph["direction"])
        rstate, tau = rng.exponential(rstate, 1.0)
        sigma = params.extinction * mu
        t_coll = jnp.where(sigma > 0.0,
                           tau / jnp.maximum(sigma, 1e-30), jnp.inf)
        collide = t_coll < t_bound
        # hops overshoot the boundary by the indexing nudge so the
        # photon provably leaves the cell (and the cube: a photon
        # parked exactly on the far face would otherwise hop by 0
        # forever, since the oob test is strict)
        dist = jnp.where(collide, t_coll,
                         t_bound + skipgrid.EPS_NUDGE)
        position = ph["position"] + dist[..., None] * ph["direction"]

        vs = scene.sample_color(position)
        alpha = vs[..., 3]
        # collision rate relative to the local majorant; the clip keeps
        # boundary-sliver lookups (skipgrid.EPS_NUDGE) conservative
        alpha = jnp.where(mu > 0.0,
                          jnp.minimum(alpha / mu, 1.0), 0.0)
        p_null = 1.0 - alpha
        capped = ph["bounces"] >= params.max_bounces
        p_scatter = jnp.where(capped, 0.0, alpha * sampling.max3(vs[..., :3]))
        p_absorb = 1.0 - p_null - p_scatter

        rstate, fortune = rng.uniform(rstate)
        oob = jnp.any((position > 1.0) | (position < 0.0), axis=-1)
        interact = (~oob) & collide
        absorb = interact & (fortune < p_absorb)
        scatter = interact & (~absorb) & (fortune < p_absorb + p_scatter)
        deposit = oob | absorb

        # radiance deposit: env radiance on escape, black on absorption,
        # Welford-style running mean (glsl:147-157)
        env = scene.sample_env(ph["direction"])
        r_new = jnp.where(oob[..., None],
                          ph["transmittance"] * env[..., :3], 0.0)
        samples = jnp.where(deposit, ph["samples"] + 1.0, ph["samples"])
        radiance = jnp.where(
            deposit[..., None],
            ph["radiance"] + (r_new - ph["radiance"])
            / jnp.maximum(samples, 1.0)[..., None],
            ph["radiance"])

        # tentative branch continuations — state advances only per the
        # draws the taken branch consumes
        rs_reset, pos_reset, dir_reset = _photon_reset(
            rstate, ndc, scene, params, inv_res)
        rs_scat, dir_scat = sampling.henyey_greenstein(
            rstate, params.anisotropy, ph["direction"])

        dmask = deposit[..., None]
        smask = scatter[..., None]
        new_ph = {
            "position": jnp.where(dmask, pos_reset, position),
            "direction": jnp.where(dmask, dir_reset,
                                   jnp.where(smask, dir_scat,
                                             ph["direction"])),
            "bounces": jnp.where(deposit, 0.0,
                                 jnp.where(scatter, ph["bounces"] + 1.0,
                                           ph["bounces"])),
            "transmittance": jnp.where(
                dmask, 1.0,
                jnp.where(smask, ph["transmittance"] * vs[..., :3],
                          ph["transmittance"])),
            "radiance": radiance,
            "samples": samples,
        }
        if "cheb" in ph:
            # a tracking-era state resumed against a non-tracking scene
            # (e.g. checkpoint + --tracking none, or the auto policy
            # flipping after a TF edit): thread the stale carry unchanged
            # so the fori_loop pytree structure stays consistent
            new_ph["cheb"] = ph["cheb"]
        new_state = jnp.where(deposit, rs_reset,
                              jnp.where(scatter, rs_scat, rstate))
        return new_ph, new_state

    ph, _ = lax.fori_loop(0, params.steps, event, (state, rstate))
    return ph


def display(state, scene: Scene, params: Params):
    """vec4(radiance, 1) (MCM render fragment)."""
    radiance = state["radiance"]
    return jnp.concatenate(
        [radiance, jnp.ones(radiance.shape[:-1] + (1,), jnp.float32)],
        axis=-1)
