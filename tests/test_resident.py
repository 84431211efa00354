"""Resident-photon ray handoff (parallel/resident.py) must reproduce the
replicated MCM render: photons migrate between slab owners instead of
every chip replicating the event logic (SURVEY §2h item 2's second
design, §7 hard part 4).  Scope mirrors test_halo: discrete fields
(samples, bounces) bitwise, float fields to the shard_map partitioner's
1-ulp FMA codegen (atol 2e-7); stall-free runs additionally keep the
radiance means bitwise because every photon executes the byte-identical
flight/interact sequence on the same values."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vpt_jax import transfer, volume
from vpt_jax.parallel import make_mesh
from vpt_jax.parallel.halo import HaloScene
from vpt_jax.parallel.resident import (
    assemble, resident_render_frame, resident_reset, slab_owner,
)
from vpt_jax.renderers import make_scene, mcm

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _scene(pack=True, tracking="none"):
    tf = np.asarray(transfer.gray_ramp(alpha_scale=1.0)).copy()
    if tracking != "none":
        tf[:, :8, 3] = 0.0                  # exactly-empty cells for cheb
    return make_scene(volume.blobs_volume(16, seed=5), jnp.asarray(tf),
                      pack=pack, tracking=tracking)


def _replicated(scene, params, h, w, frames):
    st = mcm.reset(params, h, w, scene)
    for fr in range(1, frames + 1):
        st = mcm.render_frame(st, scene, params, jnp.float32(0.1 * fr),
                              jnp.int32(fr))
    return {k: np.asarray(v) for k, v in st.items()}


def _resident(scene, params, h, w, frames, space, capacity=None,
              fanout=None):
    mesh = make_mesh(8, space=space)
    pool = resident_reset(scene, params, h, w, mesh, num_slabs=space,
                          capacity=capacity)
    frame_fn, tables = resident_render_frame(mesh, scene, space, h, w,
                                             fanout=fanout)
    for fr in range(1, frames + 1):
        pool = frame_fn(pool, tables, params, jnp.float32(0.1 * fr),
                        jnp.int32(fr))
    return pool


def _check_match(ref, pool, h, w, exact_floats=False):
    got = {k: np.asarray(v) for k, v in assemble(pool, h, w).items()}
    for k in ("samples", "bounces"):
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    for k in ("position", "direction", "transmittance", "radiance"):
        if exact_floats:
            np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
        else:
            np.testing.assert_allclose(ref[k], got[k], atol=2e-7,
                                       err_msg=k)


@pytest.mark.parametrize("pack", [False, True],
                         ids=["unpacked", "corner-packed"])
def test_resident_matches_replicated(pack):
    scene = _scene(pack=pack)
    params = mcm.Params(extinction=25.0, steps=8)
    h = w = 16
    ref = _replicated(scene, params, h, w, frames=3)
    pool = _resident(scene, params, h, w, frames=3, space=4)
    assert int(np.asarray(pool["stalled"]).sum()) == 0
    assert int(np.asarray(pool["dropped"]).sum()) == 0
    assert int(np.asarray(pool["migrated"]).sum()) > 0  # handoff happened
    _check_match(ref, pool, h, w)


def test_resident_cheb_tracking_matches_replicated():
    scene = _scene(tracking="cheb")
    assert scene.tracking_packed is not None
    params = mcm.Params(extinction=25.0, steps=8)
    h = w = 16
    ref = _replicated(scene, params, h, w, frames=2)
    pool = _resident(scene, params, h, w, frames=2, space=4)
    assert int(np.asarray(pool["stalled"]).sum()) == 0
    _check_match(ref, pool, h, w)
    got = {k: np.asarray(v) for k, v in assemble(pool, h, w).items()}
    np.testing.assert_allclose(ref["cheb"], got["cheb"], atol=2e-7)


@pytest.mark.parametrize("interleave", [2, 4])
def test_resident_cyclic_interleave_matches_replicated(interleave):
    """Cyclic thin-slab assignment (the load-balance mode: chip c owns
    thin slabs {c, c+S, …}) must stay exact — same addressing contract,
    just a different owner permutation and local table layout."""
    scene = _scene()
    params = mcm.Params(extinction=25.0, steps=8)
    h = w = 16
    ref = _replicated(scene, params, h, w, frames=2)
    mesh = make_mesh(8, space=4)
    pool = resident_reset(scene, params, h, w, mesh, num_slabs=4,
                          interleave=interleave)
    frame_fn, tables = resident_render_frame(mesh, scene, 4, h, w,
                                             interleave=interleave)
    for fr in range(1, 3):
        pool = frame_fn(pool, tables, params, jnp.float32(0.1 * fr),
                        jnp.int32(fr))
    assert int(np.asarray(pool["stalled"]).sum()) == 0
    _check_match(ref, pool, h, w)
    # thinner slabs must migrate more than the contiguous layout
    pool1 = _resident(scene, params, h, w, frames=2, space=4)
    assert int(np.asarray(pool["migrated"]).sum()) \
        > int(np.asarray(pool1["migrated"]).sum())


def test_resident_space2_data4():
    scene = _scene()
    params = mcm.Params(extinction=25.0, steps=8)
    h = w = 16
    ref = _replicated(scene, params, h, w, frames=2)
    pool = _resident(scene, params, h, w, frames=2, space=2)
    _check_match(ref, pool, h, w)


def test_resident_stall_never_loses_photons():
    """Force migration overflow (fanout=2): stalled photons wait and
    retry — the pool must keep exactly one photon per pixel, drop
    nothing, and still land every sample count at (or behind, by at most
    the stall delay) the replicated machine's."""
    scene = _scene()
    params = mcm.Params(extinction=25.0, steps=8)
    h = w = 16
    ref = _replicated(scene, params, h, w, frames=3)
    pool = _resident(scene, params, h, w, frames=3, space=4, fanout=2)
    assert int(np.asarray(pool["dropped"]).sum()) == 0
    assert int(np.asarray(pool["stalled"]).sum()) > 0  # overflow happened
    occ = np.asarray(pool["occupied"])
    pid = np.asarray(pool["pixel_id"])[occ]
    assert occ.sum() == h * w
    assert sorted(pid.tolist()) == list(range(h * w))
    got = {k: np.asarray(v) for k, v in assemble(pool, h, w).items()}
    # most photons were never stalled and match the replicated machine
    # exactly; stalled ones diverge to an independent (valid) stream
    # because they skip the frame-boundary reseed (module docstring)
    frac_exact = float(np.mean(got["samples"] == ref["samples"]))
    assert frac_exact > 0.25
    # the stalled remainder still renders the same scene: radiance means
    # agree statistically
    assert abs(float(got["radiance"].mean())
               - float(ref["radiance"].mean())) < 0.05


def test_resident_capacity_spill_init():
    """capacity < pixels-per-group forces the reset distributor to spill
    committed photons to other pools, and the grant protocol to ration
    free slots.  Nothing may ever drop; the frame matches bitwise
    whenever no stall occurred, statistically otherwise."""
    scene = _scene()
    params = mcm.Params(extinction=25.0, steps=8)
    h = w = 16
    group = h * w // 2                       # data=2 groups of 128
    ref = _replicated(scene, params, h, w, frames=6)
    pool = _resident(scene, params, h, w, frames=6, space=4,
                     capacity=group // 2)    # half the stall-free pool
    assert int(np.asarray(pool["dropped"]).sum()) == 0
    occ = np.asarray(pool["occupied"])
    assert occ.sum() == h * w                # no photon lost
    if int(np.asarray(pool["stalled"]).sum()) == 0:
        _check_match(ref, pool, h, w)
    else:
        got = {k: np.asarray(v) for k, v in assemble(pool, h, w).items()}
        assert abs(float(got["radiance"].mean())
                   - float(ref["radiance"].mean())) < 0.05


def test_resident_amortized_space1_is_exact():
    """migrate_every > 1 with one slab: nothing can ever park, so the
    event schedule — and therefore every field — is bitwise the exact
    machine's (the amortized inner loop is the same (fly, interact)
    sequence)."""
    scene = _scene()
    params = mcm.Params(extinction=25.0, steps=8)
    h = w = 16
    ref = _replicated(scene, params, h, w, frames=2)
    mesh = make_mesh(8, space=1)
    pool = resident_reset(scene, params, h, w, mesh, num_slabs=1)
    frame_fn, tables = resident_render_frame(mesh, scene, 1, h, w,
                                             migrate_every=4)
    for fr in range(1, 3):
        pool = frame_fn(pool, tables, params, jnp.float32(0.1 * fr),
                        jnp.int32(fr))
    _check_match(ref, pool, h, w)


def test_resident_amortized_parks_not_drops():
    """space=4 with migrate_every=2: crossers park for ≤1 event per
    crossing — photons conserved, nothing dropped, deposits within the
    parking deficit of the replicated machine, radiance statistical."""
    scene = _scene()
    params = mcm.Params(extinction=25.0, steps=8)
    h = w = 16
    frames = 3
    ref = _replicated(scene, params, h, w, frames=frames)
    mesh = make_mesh(8, space=4)
    pool = resident_reset(scene, params, h, w, mesh, num_slabs=4,
                          interleave=2)
    frame_fn, tables = resident_render_frame(mesh, scene, 4, h, w,
                                             interleave=2,
                                             migrate_every=2)
    for fr in range(1, frames + 1):
        pool = frame_fn(pool, tables, params, jnp.float32(0.1 * fr),
                        jnp.int32(fr))
    assert int(np.asarray(pool["dropped"]).sum()) == 0
    occ = np.asarray(pool["occupied"])
    assert occ.sum() == h * w
    pid = np.asarray(pool["pixel_id"])[occ]
    assert sorted(pid.tolist()) == list(range(h * w))
    got = {k: np.asarray(v) for k, v in assemble(pool, h, w).items()}
    # parking delays events: total deposits can only trail the exact
    # machine, and not by more than the crossing traffic
    assert got["samples"].sum() <= ref["samples"].sum()
    assert got["samples"].sum() > 0.8 * ref["samples"].sum()
    assert abs(float(got["radiance"].mean())
               - float(ref["radiance"].mean())) < 0.05


def test_slab_owner_matches_halo_addressing():
    """Ownership must agree with HaloScene._cell_coords' `local` mask —
    otherwise a resident photon could gather a cell its slab lacks."""
    rs = np.random.default_rng(0)
    pos = jnp.asarray(rs.uniform(-0.2, 1.2, size=(512, 3)),
                      jnp.float32)
    d = 16
    num = 4
    owner = np.asarray(slab_owner(pos, d, num))
    vol = volume.blobs_volume(16, seed=5).data
    for s in range(num):
        h = HaloScene(jnp.zeros((d // num + 1, 16, 16, 1)), s, num,
                      (d, 16, 16, 1), None, None, None, None, None)
        local = np.asarray(h._cell_coords(pos)[-1])
        np.testing.assert_array_equal(local, owner == s)


def test_resident_undersized_pool_raises():
    scene = _scene()
    mesh = make_mesh(8, space=4)
    with pytest.raises(ValueError, match="cannot hold"):
        resident_reset(scene, mcm.Params(), 16, 16, mesh, num_slabs=4,
                       capacity=16)
