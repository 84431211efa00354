import json
import zipfile

import numpy as np
import jax.numpy as jnp
import pytest

from vpt_jax import volume as vol_mod
from vpt_jax.io import (
    BVPReader, BytesLoader, FileLoader, HTTPLoader, RAWReader, ZipRangeReader,
    load_volume, make_loader, read_image, write_bvp, write_png,
)


def test_file_loader_ranges(tmp_path):
    p = tmp_path / "data.bin"
    p.write_bytes(bytes(range(256)))
    loader = FileLoader(p)
    assert loader.read_length() == 256
    assert loader.read_data(10, 20) == bytes(range(10, 20))


def test_bytes_loader():
    loader = BytesLoader(b"hello world")
    assert loader.read_length() == 11
    assert loader.read_data(6, 11) == b"world"


def test_make_loader_dispatch(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"abc")
    assert isinstance(make_loader(p), FileLoader)
    assert isinstance(make_loader(b"abc"), BytesLoader)
    assert isinstance(make_loader("http://x/y"), HTTPLoader)


def test_zip_range_reader_stored(tmp_path):
    p = tmp_path / "test.zip"
    with zipfile.ZipFile(p, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("manifest.json", '{"hello": 1}')
        zf.writestr("sub/data.raw", b"\x01\x02\x03")
    reader = ZipRangeReader(p)
    assert set(reader.namelist()) == {"manifest.json", "sub/data.raw"}
    assert json.loads(reader.read_file("manifest.json")) == {"hello": 1}
    assert reader.read_file("sub/data.raw") == b"\x01\x02\x03"


def test_zip_range_reader_deflate(tmp_path):
    p = tmp_path / "test.zip"
    payload = b"A" * 10000
    with zipfile.ZipFile(p, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("big.bin", payload)
    assert ZipRangeReader(p).read_file("big.bin") == payload


def test_zip_reader_missing_entry(tmp_path):
    p = tmp_path / "test.zip"
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("a", b"1")
    with pytest.raises(KeyError):
        ZipRangeReader(p).read_file("nope")


def test_raw_reader_roundtrip(tmp_path):
    data = np.arange(4 * 3 * 2, dtype=np.uint8).reshape(2, 3, 4)
    p = tmp_path / "vol.raw"
    p.write_bytes(data.tobytes())
    reader = RAWReader(p, width=4, height=3, depth=2)
    meta = reader.read_metadata()
    assert meta["modalities"][0]["dimensions"] == {
        "width": 4, "height": 3, "depth": 2}
    vol = load_volume(reader)
    assert vol.data.shape == (2, 3, 4, 1)
    assert np.allclose(np.asarray(vol.data[..., 0]) * 255, data, atol=0.5)


def test_bvp_roundtrip(tmp_path):
    src = vol_mod.sphere_volume(8)
    p = tmp_path / "vol.bvp"
    write_bvp(p, src)
    progress = []
    vol = load_volume(BVPReader(p), progress=progress.append)
    assert vol.data.shape == src.data.shape
    assert np.allclose(np.asarray(vol.data), np.asarray(src.data),
                       atol=1 / 255)
    assert progress[-1] == 1.0


def test_bvp_over_http_range_server(tmp_path):
    """Full streaming path: BVP archive served over HTTP with Range
    requests (the AjaxLoader → server-node parity pair)."""
    from vpt_jax.io.server import serve_background

    src = vol_mod.blobs_volume(8, seed=3)
    write_bvp(tmp_path / "vol.bvp", src)
    server, port = serve_background(str(tmp_path))
    try:
        vol = load_volume(BVPReader(f"http://127.0.0.1:{port}/vol.bvp"))
        assert np.allclose(np.asarray(vol.data), np.asarray(src.data),
                           atol=1 / 255)
    finally:
        server.shutdown()


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((16, 16, 4)).astype(np.float32)
    p = tmp_path / "out.png"
    write_png(p, img)
    back = read_image(p)
    assert back.shape == (16, 16, 4)
    assert np.allclose(back[..., :3], np.clip(img[..., :3], 0, 1),
                       atol=1 / 255 + 1e-3)


def test_bvp_multi_modality(tmp_path):
    from vpt_jax.io.readers import list_modalities

    ct = vol_mod.sphere_volume(8)
    pet = vol_mod.blobs_volume(8, seed=5)
    path = tmp_path / "multi.bvp"
    write_bvp(path, {"ct": ct, "pet": pet})

    reader = BVPReader(str(path))
    names = [m["name"] for m in list_modalities(reader)]
    assert names == ["ct", "pet"]

    got_ct = load_volume(reader, modality="ct")
    got_pet = load_volume(reader, modality="pet")
    assert np.allclose(np.asarray(got_ct.data), np.asarray(ct.data),
                       atol=1 / 255)
    assert np.allclose(np.asarray(got_pet.data), np.asarray(pet.data),
                       atol=1 / 255)

    with pytest.raises(ValueError, match="'mri' does not exist"):
        load_volume(reader, modality="mri")
