"""The numpy + zlib PNG codec (vpt_jax/io/image.py), and the render and
viewer paths running with Pillow unavailable."""

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from vpt_jax.io.image import decode_png, encode_png, read_image, write_png

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
def test_encode_decode_roundtrip(channels):
    px = np.random.default_rng(channels).integers(
        0, 256, (19, 23, channels), dtype=np.uint8)
    data = encode_png(px)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.array_equal(decode_png(data), px)


def _filtered_png(px, ftype):
    """Reference encoder: every row under PNG filter ``ftype``."""
    h, w, c = px.shape
    rows = px.reshape(h, w * c).astype(np.int32)
    out = []
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - up_left
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, up_left))
        out.append(bytes([ftype]) + ((cur - pred) & 0xFF)
                   .astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decode_every_row_filter(ftype):
    px = np.random.default_rng(ftype).integers(0, 256, (7, 11, 4),
                                               dtype=np.uint8)
    assert np.array_equal(decode_png(_filtered_png(px, ftype)), px)


def test_decode_rejects_unsupported():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    header = struct.pack(">IIBBBBB", 1, 1, 16, 2, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(header)) + b"IHDR"
            + header + b"\0\0\0\0")
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(data)


def test_read_image_adds_opaque_alpha_and_flips(tmp_path):
    img = np.zeros((4, 5, 3), np.float32)
    img[0] = 1.0                                  # bottom row (GL order)
    path = tmp_path / "x.png"
    write_png(path, img)
    back = read_image(path)
    assert back.shape == (4, 5, 4)
    assert np.array_equal(back[..., 3], np.ones((4, 5), np.float32))
    assert np.allclose(back[..., :3], img)


def _run_without_pillow(tmp_path, code):
    """Run ``code`` in a fresh CPU process where importing PIL or orbax
    fails; returns the completed process."""
    prelude = ("import sys; sys.modules['PIL'] = None; "
               "sys.modules['orbax'] = None\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    return subprocess.run([sys.executable, "-c", prelude + code],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_render_without_pillow(tmp_path):
    proc = _run_without_pillow(tmp_path, (
        "from vpt_jax import cli\n"
        "cli.main(['render', '--volume', 'sphere:8', '--renderer', 'eam',"
        " '--resolution', '16', '--spp', '1', '-o', 'r.png'])\n"))
    assert proc.returncode == 0, proc.stderr
    assert decode_png((tmp_path / "r.png").read_bytes()).shape == (16, 16, 3)


def test_viewer_frame_without_pillow(tmp_path):
    proc = _run_without_pillow(tmp_path, (
        "import urllib.request\n"
        "from vpt_jax import transfer, volume\n"
        "from vpt_jax.io.image import decode_png\n"
        "from vpt_jax.runtime import RenderingContext\n"
        "from vpt_jax.runtime.viewer import ViewerServer\n"
        "ctx = RenderingContext(resolution=16)\n"
        "ctx.set_volume(volume.sphere_volume(8))\n"
        "ctx.set_transfer_function(transfer.gray_ramp())\n"
        "srv = ViewerServer(ctx, port=0)\n"
        "port = srv.serve_background()\n"
        "base = f'http://127.0.0.1:{port}'\n"
        "for path in ('/frame?spp=1', '/tf.png'):\n"
        "    body = urllib.request.urlopen(base + path, timeout=120).read()\n"
        "    print(path, decode_png(body).shape)\n"
        "srv.shutdown()\n"))
    assert proc.returncode == 0, proc.stderr
    assert "/frame?spp=1 (16, 16, 3)" in proc.stdout
    assert "/tf.png" in proc.stdout


def test_fit_bench_and_smoke_import_without_pillow(tmp_path):
    write_png(tmp_path / "t.png", np.full((12, 12, 3), 0.25, np.float32))
    proc = _run_without_pillow(tmp_path, (
        "import bench, chip_smoke\n"
        "from vpt_jax import cli\n"
        "cli.main(['fit', '--target', 't.png', '--grid', '8', '--steps',"
        " '2', '--eam-slices', '8', '-o', 'vol'])\n"))
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "vol.npy").exists()
    assert decode_png((tmp_path / "vol.png").read_bytes()).shape == (12, 12, 3)
