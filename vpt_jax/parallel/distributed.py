"""Multi-host SPMD bring-up: jax.distributed with retry + topology report.

The multi-host replacement for the reference's browser event loop and its
partial WebGL context-loss recovery (``RenderingContext.js:108-116``): hosts
join a jax.distributed cluster with bounded retries, agree on a mesh over
the global device set, and long-running progressive renders survive
restarts through the checkpoint module (runtime/checkpoint.py) — a resumed
render is bit-identical because seeds derive from frame indices.

On a single host (or under --xla_force_host_platform_device_count) this
degrades gracefully to a local mesh, so the same driver script runs
everywhere.
"""

from __future__ import annotations

import time
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               retries: int = 5, retry_delay: float = 5.0) -> bool:
    """Join (or skip) a multi-host cluster.

    Returns True when distributed init succeeded, False when running
    single-process (no coordinator configured).  Retries transient
    coordination failures — the failure-detection gap called out in
    SURVEY.md §5."""
    if coordinator_address is None and num_processes is None:
        import os

        if "JAX_COORDINATOR_ADDRESS" not in os.environ:
            return False
    last_err = None
    for attempt in range(retries):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id)
            return True
        except Exception as e:  # noqa: BLE001 — retry any transient error
            last_err = e
            time.sleep(retry_delay * (attempt + 1))
    raise RuntimeError(
        f"jax.distributed.initialize failed after {retries} attempts"
    ) from last_err


def topology_summary() -> str:
    """One-line cluster/topology report for logs."""
    devices = jax.devices()
    kinds = sorted({d.device_kind for d in devices})
    return (f"process {jax.process_index()}/{jax.process_count()}: "
            f"{len(jax.local_devices())} local / {len(devices)} global "
            f"devices ({', '.join(kinds)})")


def default_mesh(space: int = 1):
    """Mesh over all global devices: (data × space), host-major ordering —
    each space row stays within one host (mesh.device_grid), so the
    per-frame psum uses the host's card-to-card links and only data
    reductions cross hosts."""
    from .mesh import make_mesh

    return make_mesh(len(jax.devices()), space=space)
