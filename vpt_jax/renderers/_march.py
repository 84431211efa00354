"""Chunked slice marching for the fixed-schedule renderers.

The march renderers (MIP/EAM/Depth/ISO) sample the volume at a *static*
slice schedule — positions depend only on the slice index, not on carried
state — so their per-slice gathers need not be serialized the way MCM's
event chain is.  Gathering ``chunk`` slices per fetch removes that false
dependency and amortizes per-call gather cost; it also makes the slice
schedule explicit.  Whether chunking pays on the GPU is not measured yet.

Compositing stays an exact sequential fold: ``composite(carry, t, color,
valid)`` is applied slice by slice in schedule order (unrolled within the
chunk), so results are identical to the one-slice-per-step scan — `valid`
masks the padding slices when the schedule is not a chunk multiple.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def march(scene, start, end, ts, composite, carry, chunk: int = 8):
    """Fold ``composite`` over a fixed slice schedule with chunked sampling.

    ``start``/``end``: (H, W, 3) clipped ray segment; ``ts``: (S,) static
    schedule of ray parameters; ``composite(carry, t, color, valid) ->
    carry`` with ``color = scene.sample_color(start + t·(end−start))``.
    """
    n = ts.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    valid = jnp.arange(n + pad) < n
    if pad:
        ts = jnp.concatenate([ts, jnp.zeros((pad,), ts.dtype)])
    tch = ts.reshape(-1, chunk)
    vch = valid.reshape(-1, chunk)
    seg = end - start

    def step(c, tv):
        tc, vc = tv
        positions = start[None] + tc[:, None, None, None] * seg[None]
        colors = scene.sample_color(positions)      # one chunked gather
        for k in range(chunk):
            c = composite(c, tc[k], colors[k], vc[k])
        return c, None

    out, _ = lax.scan(step, carry, (tch, vch))
    return out
