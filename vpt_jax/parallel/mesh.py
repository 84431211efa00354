"""Device meshes and sharding specs for multi-chip rendering.

The reference has exactly one parallelism mode — implicit per-pixel SIMT on a
single GPU (SURVEY.md §2h).  Here the scaling axes are explicit:

- ``data``  — the pixel/sample grid, embarrassingly parallel; rows of the
  image and all per-pixel state shard across it.  Per-pixel RNG streams are
  hashes of pixel coordinates, so sharding is bit-invariant.
- ``space`` — the volume's z extent, for grids too large to replicate
  per device; trilinear reads across the partition face ride XLA's
  automatically inserted collectives or the explicit halo exchanges of
  parallel/halo.py and parallel/resident.py.

Meshes are built over whatever devices exist (the cards of one or more
hosts, or ``--xla_force_host_platform_device_count`` virtual CPUs), so the
same code path runs tests, dry-runs and multi-card renders.  The cards of
one host are joined all to all, so the mesh shape follows the algorithm;
only host boundaries are slower links.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def device_grid(devices, space: int = 1):
    """Topology-aware (data, space) device grid.

    Devices are ordered by (process_index, id) so that, whenever ``space``
    divides the per-process device count, every ``space``-row (the axis
    that runs the per-frame halo/ownership psum) lies within a single
    process — those collectives stay on the host's own card-to-card links
    — and the data-axis rows of one process are contiguous, so data
    reductions cross between hosts once per host (hierarchical) instead
    of per pair."""
    devices = sorted(devices,
                     key=lambda d: (d.process_index, getattr(d, "id", 0)))
    n = len(devices)
    if n % space != 0:
        raise ValueError(f"{n} devices not divisible by space={space}")
    per_proc = {}
    for d in devices:
        per_proc[d.process_index] = per_proc.get(d.process_index, 0) + 1
    if any(c % space for c in per_proc.values()) and len(per_proc) > 1:
        import warnings

        warnings.warn(
            f"space={space} does not divide the per-process device counts "
            f"{per_proc}; space-axis collectives will cross hosts",
            stacklevel=2)
    return np.array(devices).reshape(n // space, space)


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data", "space"),
              space: int = 1, devices=None) -> Mesh:
    """Mesh over ``n_devices`` devices, shaped (n_devices // space, space),
    with the topology-aware ordering of :func:`device_grid`."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if len(axes) == 1:
        if n_devices % space != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by space={space}")
        grid = np.array(sorted(
            devices, key=lambda d: (d.process_index, getattr(d, "id", 0))))
    else:
        grid = device_grid(devices, space)
    return Mesh(grid, axis_names=tuple(axes))


def pixel_sharding(mesh: Mesh, ndim: int = 3,
                   axis: str = "data") -> NamedSharding:
    """Shard an (H, W, ...) image/state array by rows across ``axis``."""
    spec = P(axis, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
