"""Roofline: the measured event rates against the device's ceilings.

Measured ceilings (the same call that times the renderer measures them,
so a card below its full power limit is compared with itself):

- ``measure_hbm_gbps``       — streaming triad (out = a·x + y) ceiling;
- ``measure_matmul_tflops``  — bf16 matmul ceiling;
- ``measure_gather_ns``      — in-loop gather cost per row on a table of
  the exact row count / lane width / dtype the scene uses;
- ``measure_scatter_ns``     — in-loop scatter-add cost per update row
  (the backward pass's binding primitive);
- ``event_traffic_bytes``    — an explicit memory traffic model of one
  event: read+write of every loop-carried photon array + the gathered rows.

``forward_roofline``/``backward_roofline`` combine these into the fields
bench.py embeds in the headline JSON: achieved GB/s and its fraction of
the measured stream ceiling, the gather(scatter)-bound ceiling in events/s
and the achieved fraction of it, and the matmul rate of the one-hot TF
path.  ``tf_lookup_roofline``/``tonemap_roofline`` time the TF lookup and
the tone map alone against their byte bounds at the published memory
bandwidth (``PEAKS``).  The model's arithmetic is unit-tested
(tests/test_roofline.py).

Usage: python benchmarks/roofline.py [--quick]
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np


#: published peaks by ``device_kind`` (NVIDIA H100 SXM data sheet, dense,
#: at the full 700 W power limit); a device not listed is an error
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0},
}


def peaks() -> dict:
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return PEAKS[kind]


def _timeit(fn, iters: int) -> float:
    """Mean seconds per call after one warm-up (compile) call."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def trace_busy(fn, iters: int = 20) -> tuple[float, float]:
    """``(device busy µs, wall µs)`` per call of ``fn`` over ``iters``
    back-to-back calls under the profiler.  Busy is the union of the
    intervals in which anything runs on the first GPU's plane of the
    trace, so launch gaps and host dispatch count as idle; wall includes
    them.  Raises on a backend whose trace has no GPU plane."""
    import glob
    import os
    import tempfile

    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            jax.block_until_ready(out)
            wall = time.perf_counter() - t0
        (path,) = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True)
        prof = ProfileData.from_file(path)
    planes = [pl for pl in prof.planes if pl.name.startswith("/device:GPU")]
    if not planes:
        raise RuntimeError("the trace has no GPU device plane")
    spans = sorted((ev.start_ns, ev.start_ns + ev.duration_ns)
                   for line in planes[0].lines for ev in line.events)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / iters / 1e3, wall / iters * 1e6


def measure_hbm_gbps(mbytes: int = 256, iters: int = 10) -> float:
    """Streaming ceiling: y' = a·x + y moves 12 bytes/element (read x,
    read y, write y') — the classic triad, sized well past the L2 so it
    streams from device memory."""
    import jax
    import jax.numpy as jnp

    n = mbytes * (1 << 20) // 4
    x = jnp.full((n,), 1.000001, jnp.float32)
    y = jnp.zeros((n,), jnp.float32)
    f = jax.jit(lambda x, y: x * 1.000001 + y, donate_argnums=(1,))

    y = jax.block_until_ready(f(x, y))          # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        y = f(x, y)
    jax.block_until_ready(y)
    dt = (time.perf_counter() - t0) / iters
    return 12.0 * n / dt / 1e9


def measure_matmul_tflops(n: int = 4096, iters: int = 8) -> float:
    """bf16 matmul ceiling: (n, n) @ (n, n) = 2·n³ FLOPs per call."""
    import jax
    import jax.numpy as jnp

    a = jnp.full((n, n), 0.001, jnp.bfloat16)
    b = jnp.full((n, n), 0.001, jnp.bfloat16)
    f = jax.jit(lambda a, b: a @ b)
    dt = _timeit(lambda: f(a, b), iters)
    return 2.0 * n ** 3 / dt / 1e12


def measure_gather_ns(rows: int, lanes: int = 8, dtype="bfloat16",
                      n: int = 512 * 512 * 8, inner: int = 8,
                      iters: int = 10) -> float:
    """In-loop per-row gather cost on a (rows, lanes) table — the exact
    shape class the event loop gathers from.  fori_loop body = one gather
    + an index rotation (defeats hoisting), matching the event machine's
    one-gather-per-event structure.  ``n`` defaults to 2M indices, eight
    events' worth of 512² pixels."""
    import jax
    import jax.numpy as jnp

    table = jnp.asarray(
        np.random.default_rng(0).normal(size=(rows, lanes)).astype(
            np.float32)).astype(dtype)
    idx = jnp.asarray(
        np.random.default_rng(1).integers(0, rows, n, dtype=np.int32))

    @jax.jit
    def run(idx, table):
        def body(i, acc):
            j = (idx + i) % rows
            r = jnp.take(table, j, axis=0)
            return acc + jnp.sum(r.astype(jnp.float32))
        return jax.lax.fori_loop(0, inner, body, jnp.float32(0))

    dt = _timeit(lambda: run(idx, table), iters)
    return dt / (inner * n) * 1e9


def measure_scatter_ns(rows: int, lanes: int = 128, n: int = 512 * 512,
                       inner: int = 8, iters: int = 10) -> float:
    """In-loop per-update scatter-add cost into a (rows, lanes) f32 table —
    the backward pass's binding primitive (cotangent accumulation into the
    folded corner table)."""
    import jax
    import jax.numpy as jnp

    upd = jnp.asarray(
        np.random.default_rng(0).normal(size=(n, lanes)).astype(np.float32))
    idx = jnp.asarray(
        np.random.default_rng(1).integers(0, rows, n, dtype=np.int32))

    @jax.jit
    def run(idx, upd):
        def body(i, acc):
            j = (idx + i) % rows
            return acc.at[j].add(upd, mode="promise_in_bounds")
        return jax.lax.fori_loop(0, inner, body,
                                 jnp.zeros((rows, lanes), jnp.float32))

    dt = _timeit(lambda: run(idx, upd), iters)
    return dt / (inner * n) * 1e9


def event_traffic_bytes(state, scene) -> dict:
    """Explicit device-memory traffic model of ONE event for ONE pixel.

    The fori_loop's carry (photon pytree + the uint32 RNG lane) is
    assumed to live in device memory between iterations: every event
    reads and writes each carried array once.  Each event additionally
    gathers one row of the volume (or tracking) corner table; the TF
    lookup is either a second small-table gather or a one-hot matmul
    (whose table is a (TW, 4) constant — negligible bytes, counted as
    FLOPs instead)."""
    import jax

    pixels = int(np.prod(state["position"].shape[:2]))
    carry_bytes = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                      for leaf in jax.tree_util.tree_leaves(state))
    carry_bytes += pixels * 4                       # rng uint32 lane
    per_pixel_carry = carry_bytes / pixels

    table = (scene.tracking_packed if scene.tracking_packed is not None
             else scene.volume_packed)
    if table is not None:
        row_bytes = int(table.shape[-1]) * table.dtype.itemsize
    else:                                           # unpacked: 8 corner taps
        row_bytes = 8 * scene.volume.dtype.itemsize
    tf_bytes = 0
    tf_flops = 0
    if scene.transfer_mxu is not None:
        # one-hot bilinear-weight matmul: (pixels, TW) @ (TW, 4)
        tf_flops = 2 * int(scene.transfer_mxu.shape[0]) * 4
    elif scene.transfer_packed is not None:
        tf_bytes = (int(scene.transfer_packed.shape[-1])
                    * scene.transfer_packed.dtype.itemsize)
    return {
        "carry_rw": 2.0 * per_pixel_carry,
        "volume_row": float(row_bytes),
        "tf_row": float(tf_bytes),
        "total": 2.0 * per_pixel_carry + row_bytes + tf_bytes,
        "tf_mxu_flops": float(tf_flops),
    }


def forward_roofline(events_per_s: float, state, scene,
                     hbm_gbps: float, mxu_tflops: float,
                     gather_ns: float) -> dict:
    """The forward event machine against both candidate rooflines."""
    traffic = event_traffic_bytes(state, scene)
    achieved_gbps = events_per_s * traffic["total"] / 1e9
    gather_bound = 1e9 / gather_ns
    hbm_bound = hbm_gbps * 1e9 / traffic["total"]
    return {
        "events_per_s": round(events_per_s),
        "bytes_per_event": round(traffic["total"], 1),
        "achieved_hbm_gbps": round(achieved_gbps, 2),
        "hbm_stream_gbps": round(hbm_gbps, 1),
        "hbm_fraction": round(achieved_gbps / hbm_gbps, 4),
        "gather_ns_per_row": round(gather_ns, 2),
        "gather_bound_events_per_s": round(gather_bound),
        "gather_fraction": round(events_per_s / gather_bound, 3),
        "hbm_bound_events_per_s": round(hbm_bound),
        "tf_mxu_tflops": round(
            events_per_s * traffic["tf_mxu_flops"] / 1e12, 4),
        "mxu_peak_tflops": round(mxu_tflops, 2),
        "binding_resource": ("gather" if gather_bound < hbm_bound
                             else "hbm"),
    }


def backward_roofline(grad_events_per_s: float, fold_rows: int,
                      fold_lanes: int, hbm_gbps: float,
                      gather_ns: float, scatter_ns: float) -> dict:
    """The differentiated event machine: each event costs (at least) the
    forward's gather + one scatter-add of a (fold_lanes,) f32 cotangent
    row into the folded table (sampling.scatter_fold_log2)."""
    bytes_per_event = (
        4.0 * fold_lanes          # cotangent update row (write traffic)
        + 2.0 * 4.0 * fold_lanes  # scatter read-modify-write of the table
        + 16.0)                   # forward-in-grad volume row (bf16 8-lane)
    achieved_gbps = grad_events_per_s * bytes_per_event / 1e9
    op_bound = 1e9 / (gather_ns + scatter_ns)
    return {
        "grad_events_per_s": round(grad_events_per_s),
        "fold_table": f"{fold_rows}x{fold_lanes}",
        "scatter_ns_per_update": round(scatter_ns, 2),
        "gather_ns_per_row": round(gather_ns, 2),
        "op_bound_events_per_s": round(op_bound),
        "op_fraction": round(grad_events_per_s / op_bound, 3),
        "min_bytes_per_event": round(bytes_per_event, 1),
        "achieved_hbm_gbps": round(achieved_gbps, 2),
        "hbm_stream_gbps": round(hbm_gbps, 1),
        "hbm_fraction": round(achieved_gbps / hbm_gbps, 4),
    }


def tf_lookup_roofline(res: int = 512, events: int = 8,
                       iters: int = 20) -> dict:
    """The 1D TF lookup alone — ``res``² pixels × ``events`` lookups of a
    256-texel row, as the gather path (bilinear at y = 0 from the packed
    table) and as the one-hot matmul — against its byte bound: a 4 B value
    read and a 16 B RGBA write per lookup at the published bandwidth."""
    import jax
    import jax.numpy as jnp

    from vpt_jax import sampling, transfer

    tf = transfer.gray_ramp(alpha_scale=0.8)
    n = res * res * events
    values = jax.random.uniform(jax.random.PRNGKey(0), (n,), jnp.float32)
    packed = sampling.pack_corner_texture2d(tf)
    gather = jax.jit(lambda v: sampling.sample_texture2d_packed(
        packed, tf.shape, jnp.stack([v, jnp.zeros_like(v)], axis=-1)))
    out = {"lookups": n,
           "bound_us": round(n * 20.0 / (peaks()["hbm_gbps"] * 1e3), 2)}
    for name, fn in (("gather", gather),
                     ("one_hot_f32", jax.jit(functools.partial(
                         sampling.sample_transfer_1d_mxu,
                         sampling.pack_mxu_transfer(tf, jnp.float32)))),
                     ("one_hot_bf16", jax.jit(functools.partial(
                         sampling.sample_transfer_1d_mxu,
                         sampling.pack_mxu_transfer(tf, jnp.bfloat16))))):
        out.update(_timings(name, lambda fn=fn: fn(values), iters))
    return out


def _timings(name: str, call, iters: int) -> dict:
    """``{name}_us`` (wall per call, dispatch included) and
    ``{name}_device_us`` (device busy per call, from a trace)."""
    return {f"{name}_us": round(_timeit(call, iters) * 1e6, 2),
            f"{name}_device_us": round(trace_busy(call, iters)[0], 2)}


def tonemap_roofline(res: int = 1024, iters: int = 50) -> dict:
    """``tonemap.ToneMapper`` (reinhard) alone at ``res``² against 32 B/px
    (16 B RGBA float read + 16 B write) at the published bandwidth."""
    import jax
    import jax.numpy as jnp

    from vpt_jax import tonemap

    img = jax.random.uniform(jax.random.PRNGKey(1), (res, res, 4),
                             jnp.float32, 0.0, 4.0)
    mapper = tonemap.ToneMapper("reinhard", {})
    fn = jax.jit(lambda x: mapper(x))
    return {"pixels": res * res,
            "bound_us": round(res * res * 32.0
                              / (peaks()["hbm_gbps"] * 1e3), 2),
            **_timings("measured", lambda: fn(img), iters)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller sizes / fewer iters")
    args = ap.parse_args()

    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    from vpt_jax.renderers import mcm
    from vpt_jax.runtime import device

    device.enable_compile_cache()
    device.require_gpu()
    print(f"# card: {device.card_report()}", file=sys.stderr)
    q = args.quick
    hbm = measure_hbm_gbps(mbytes=64 if q else 256, iters=3 if q else 10)
    mxu = measure_matmul_tflops(n=1024 if q else 4096, iters=3 if q else 8)
    print(f"# measured ceilings: memory stream {hbm:.1f} GB/s, "
          f"bf16 matmul {mxu:.2f} TFLOP/s", file=sys.stderr)
    for name in ("headline-srgb-auto/steps32", "dense256-srgb-auto/steps32"):
        builder, steps, frames, ext = bench.CONFIGS[name]
        scene = builder()
        ev, _ = bench.time_config(scene, steps=steps,
                                  frames=2 if q else frames, extinction=ext)
        params = mcm.Params(extinction=ext, anisotropy=0.3, steps=steps)
        state = mcm.reset(params, 512, 512, scene)
        rows = int((scene.tracking_packed
                    if scene.tracking_packed is not None
                    else scene.volume_packed).shape[0])
        g_ns = measure_gather_ns(rows, n=1 << 14 if q else 512 * 512,
                                 iters=3 if q else 10)
        out = forward_roofline(ev, state, scene, hbm, mxu, g_ns)
        out["config"] = name
        print(json.dumps(out), flush=True)

    # backward at 128³ and the milestone 256³ scale
    from benchmarks import backward as bwd_mod

    for vol_n in (128, 256):
        from vpt_jax import sampling

        fold = sampling.scatter_fold_log2(vol_n ** 3, 8, vol_n)
        rows, lanes = (vol_n ** 3) >> fold, 8 << fold
        row = bwd_mod.bench(128 if q else 512, vol_n, 8, 2,
                            "folded", iters=2 if q else 6)
        g_ns = measure_gather_ns(rows, lanes=lanes,
                                 n=1 << 14 if q else 512 * 512,
                                 iters=3 if q else 10)
        s_ns = measure_scatter_ns(rows, lanes=lanes,
                                  n=1 << 14 if q else 512 * 512,
                                  iters=3 if q else 8)
        out = backward_roofline(row["value"], rows, lanes, hbm, g_ns, s_ns)
        out["config"] = row["config"]
        print(json.dumps(out), flush=True)
    print(json.dumps({"tf_lookup": tf_lookup_roofline(),
                      "tonemap": tonemap_roofline()}), flush=True)


if __name__ == "__main__":
    main()
