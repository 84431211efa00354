"""Unit tests for the roofline traffic model and roofline field
arithmetic (benchmarks/roofline.py)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import roofline  # noqa: E402
from vpt_jax import transfer, volume  # noqa: E402
from vpt_jax.renderers import make_scene, mcm  # noqa: E402


# ---------------------------------------------------------------------------
# Event traffic model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tracking_scene():
    tf = np.asarray(transfer.gray_ramp(alpha_scale=0.8)).copy()
    tf[:, :8, 3] = 0.0
    return make_scene(volume.sphere_volume(16), jnp.asarray(tf),
                      pack_dtype=jnp.bfloat16, tf_mxu=True, tracking="cheb")


def test_event_traffic_bytes_arithmetic(tracking_scene):
    params = mcm.Params(extinction=20.0, steps=4)
    h = w = 8
    state = mcm.reset(params, h, w, tracking_scene)
    t = roofline.event_traffic_bytes(state, tracking_scene)
    # carry: position 12 + direction 12 + bounces 4 + transmittance 12 +
    # radiance 12 + samples 4 + cheb 4 + rng 4 = 64 B/pixel, read + write
    assert t["carry_rw"] == pytest.approx(128.0)
    # tracking table rows are 8 bf16 lanes = 16 B
    assert t["volume_row"] == 16.0
    assert t["tf_row"] == 0.0            # one-hot path: FLOPs, not bytes
    assert t["tf_mxu_flops"] == 2 * 256 * 4
    assert t["total"] == pytest.approx(128.0 + 16.0)


def test_event_traffic_bytes_gather_tf():
    sc = make_scene(volume.sphere_volume(16),
                    transfer.gray_ramp(alpha_scale=0.8))  # f32, TF gather
    params = mcm.Params(extinction=20.0, steps=4)
    state = mcm.reset(params, 8, 8, sc)
    t = roofline.event_traffic_bytes(state, sc)
    assert t["volume_row"] == 8 * 4       # f32 8-lane corner row
    assert t["tf_row"] == sc.transfer_packed.shape[-1] * 4
    assert t["tf_mxu_flops"] == 0


# ---------------------------------------------------------------------------
# Roofline field arithmetic
# ---------------------------------------------------------------------------

def test_forward_roofline_fields(tracking_scene):
    params = mcm.Params(extinction=20.0, steps=4)
    state = mcm.reset(params, 8, 8, tracking_scene)
    out = roofline.forward_roofline(
        events_per_s=100e6, state=state, scene=tracking_scene,
        hbm_gbps=800.0, mxu_tflops=9.0, gather_ns=5.0)
    assert out["gather_bound_events_per_s"] == 200_000_000
    assert out["gather_fraction"] == pytest.approx(0.5)
    assert out["achieved_hbm_gbps"] == pytest.approx(
        100e6 * out["bytes_per_event"] / 1e9, rel=1e-3)
    assert out["hbm_fraction"] == pytest.approx(
        out["achieved_hbm_gbps"] / 800.0, rel=1e-2)
    # the gather bound binds long before the stream bound on these numbers
    assert out["binding_resource"] == "gather"
    assert out["hbm_bound_events_per_s"] > out["gather_bound_events_per_s"]


def test_backward_roofline_fields():
    out = roofline.backward_roofline(
        grad_events_per_s=20e6, fold_rows=1 << 18, fold_lanes=64,
        hbm_gbps=800.0, gather_ns=5.0, scatter_ns=20.0)
    assert out["op_bound_events_per_s"] == 40_000_000
    assert out["op_fraction"] == pytest.approx(0.5)
    # bytes: update row 256 + RMW 512 + fwd row 16
    assert out["min_bytes_per_event"] == pytest.approx(256 + 512 + 16)


# ---------------------------------------------------------------------------
# Published peaks and the single-layer byte bounds
# ---------------------------------------------------------------------------

def test_peaks_reject_unknown_device():
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peaks()


@pytest.fixture
def cpu_peaks(monkeypatch):
    """Peaks for the CPU device and a stand-in for the GPU trace, so the
    byte-bound plumbing runs here."""
    import jax

    kind = jax.devices()[0].device_kind
    monkeypatch.setitem(roofline.PEAKS, kind,
                        {"hbm_gbps": 100.0, "bf16_tflops": 1.0})
    monkeypatch.setattr(roofline, "trace_busy",
                        lambda call, iters: (1.5, 3.0))


def test_tf_lookup_roofline_fields(cpu_peaks):
    out = roofline.tf_lookup_roofline(res=16, events=2, iters=1)
    assert out["lookups"] == 16 * 16 * 2
    # 4 B read + 16 B write per lookup at 100 GB/s
    assert out["bound_us"] == pytest.approx(512 * 20 / 100e3, abs=0.01)
    for name in ("gather", "one_hot_f32", "one_hot_bf16"):
        assert out[f"{name}_us"] > 0.0
        assert out[f"{name}_device_us"] == 1.5


def test_tonemap_roofline_fields(cpu_peaks):
    out = roofline.tonemap_roofline(res=32, iters=1)
    assert out["pixels"] == 32 * 32
    assert out["bound_us"] == pytest.approx(32 * 32 * 32 / 100e3, abs=0.01)
    assert out["measured_us"] > 0.0
    assert out["measured_device_us"] == 1.5


def test_trace_busy_needs_a_gpu_plane():
    import jax
    import jax.numpy as jnp

    fn = jax.jit(lambda x: x * 2.0)
    x = jnp.ones((64,))
    with pytest.raises(RuntimeError, match="no GPU device plane"):
        roofline.trace_busy(lambda: fn(x), iters=2)
