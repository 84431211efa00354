import json

import numpy as np
import jax.numpy as jnp
import pytest

from vpt_jax import colorspaces, utils
from vpt_jax.tools import packer


def test_hex_rgb_roundtrip():
    assert utils.hex2rgb("#ff8000") == (1.0, 128 / 255.0, 0.0)
    assert utils.rgb2hex(1.0, 128 / 255.0, 0.0) == "#ff8000"


def test_interp_helpers():
    assert float(utils.lerp(0.0, 10.0, 0.25)) == 2.5
    assert float(utils.step(0.5, 0.4)) == 0.0
    assert float(utils.step(0.5, 0.6)) == 1.0
    assert float(utils.smoothstep(0.0, 1.0, 0.5)) == 0.5


def test_json_roundtrip(tmp_path):
    p = tmp_path / "x.json"
    utils.download_json({"a": [1, 2]}, p)
    assert utils.read_json(p) == {"a": [1, 2]}


def test_colorspace_roundtrips():
    rgb = jnp.array([[0.2, 0.5, 0.8]])
    assert np.allclose(np.asarray(colorspaces.xyz2rgb(
        colorspaces.rgb2xyz(rgb))), np.asarray(rgb), atol=1e-4)
    for std in ("bt601", "bt709"):
        back = colorspaces.yuv2rgb(colorspaces.rgb2yuv(rgb, std), std)
        assert np.allclose(np.asarray(back), np.asarray(rgb), atol=1e-2)
    xyz = colorspaces.rgb2xyz(rgb)
    assert np.allclose(np.asarray(colorspaces.xyY2xyz(
        colorspaces.xyz2xyY(xyz))), np.asarray(xyz), atol=1e-5)


def test_float_rgba_packing():
    x = jnp.array([0.12345, 0.9999, 0.0])
    back = colorspaces.rgba_to_float(colorspaces.float_to_rgba(x))
    assert np.allclose(np.asarray(back), np.asarray(x), atol=1e-6)


def test_encode_float_exact():
    x = jnp.array([0.0, 1.0, -3.14159, 1e-20, 12345.678], jnp.float32)
    back = colorspaces.decode_float(colorspaces.encode_float(x))
    assert np.array_equal(np.asarray(back), np.asarray(x))


def test_hue_endpoints():
    out = np.asarray(colorspaces.hue(jnp.array([0.0, 0.5, 1.0])))
    assert out.shape == (3, 4)
    assert np.all(out[:, 3] == 1.0)


# --- packer ---------------------------------------------------------------

SRC = """\
// #part /lib/constants
PI = 3.14
// #part /lib/helper
// #link /lib/constants
def helper(): pass
// #part /main/prog
// #link /lib/helper
def main(): pass
"""


def test_parse_parts():
    parts = packer.parse_parts(SRC)
    assert set(parts) == {"/lib/constants", "/lib/helper", "/main/prog"}
    assert parts["/main/prog"]["links"] == ["/lib/helper"]


def test_toposort_orders_links_first():
    parts = packer.parse_parts(SRC)
    order = packer.toposort(parts)
    assert order.index("/lib/constants") < order.index("/lib/helper")
    assert order.index("/lib/helper") < order.index("/main/prog")


def test_resolve_transitive():
    parts = packer.parse_parts(SRC)
    text = packer.resolve(parts, "/main/prog")
    assert "PI = 3.14" in text and "def helper" in text \
        and "def main" in text
    assert text.index("PI") < text.index("helper") < text.index("main")


def test_cycle_detection():
    src = """\
// #part /a
// #link /b
A
// #part /b
// #link /a
B
"""
    with pytest.raises(packer.CyclicLinkError):
        packer.toposort(packer.parse_parts(src))


def test_pack_json_output(tmp_path):
    (tmp_path / "src.glsl").write_text(SRC)
    config = {
        "inputs": [{"path": "src.glsl", "action": "parse"}],
        "outputs": [{"mode": "json", "path": "build/parts.json"}],
    }
    packer.pack(config, tmp_path)
    tree = json.loads((tmp_path / "build/parts.json").read_text())
    assert "PI = 3.14" in tree["lib"]["constants"]


def test_pack_concat_and_each(tmp_path):
    (tmp_path / "src.glsl").write_text(SRC)
    packer.pack({
        "inputs": [{"path": "src.glsl"}],
        "outputs": [{"mode": "concat", "path": "build/all.txt"},
                    {"mode": "each", "path": "build/each"}],
    }, tmp_path)
    allt = (tmp_path / "build/all.txt").read_text()
    assert allt.index("PI") < allt.index("def main")
    assert (tmp_path / "build/each/lib_constants").exists()


def test_cli_info_runs(capsys):
    from vpt_jax import cli

    cli.main(["info"])
    out = capsys.readouterr().out
    assert "mcm" in out and "tone mappers" in out


def test_cli_render_end_to_end(tmp_path):
    from vpt_jax import cli

    out = tmp_path / "r.png"
    cli.main(["render", "--volume", "sphere:16", "--renderer", "mip",
              "--resolution", "24", "--spp", "1", "--tonemap", "reinhard",
              "-o", str(out)])
    assert out.exists()


def test_cli_fit_multiview(tmp_path):
    import math

    from vpt_jax import cli, transfer, volume
    from vpt_jax.io.image import write_png
    from vpt_jax.renderers import eam
    from vpt_jax.runtime.animators import OrbitCameraAnimator
    from vpt_jax.scene import CameraState, default_camera
    from vpt_jax.train import render_eam

    # two orbit views of a tiny sphere as fit targets
    tf = transfer.gray_ramp(alpha_scale=1.0)
    truth = volume.sphere_volume(8)
    cam = default_camera()
    orbit = OrbitCameraAnimator(cam)
    paths = []
    for i, yaw_deg in enumerate((0.0, 180.0)):
        orbit.yaw = math.radians(yaw_deg)
        orbit._update_camera()
        cs = CameraState.from_nodes(cam)
        img = render_eam(truth.data, tf, (cs.mvp_inverse, cs.model_view,
                                          cs.projection),
                         eam.Params(slices=16, random=False),
                         jnp.float32(0.0), 24, 24)
        p = tmp_path / f"t{i}.png"
        write_png(p, np.asarray(img))
        paths.append(str(p))

    out = tmp_path / "vol"
    cli.main(["fit", "--target", *paths, "--view-yaw", "0", "180",
              "--grid", "8", "--steps", "3", "--eam-slices", "16",
              "-o", str(out)])
    fitted = np.load(str(out) + ".npy")
    assert fitted.shape == (8, 8, 8, 1)
    assert (tmp_path / "vol.png").exists()

    # non-eam methods reject multiple targets
    with pytest.raises(SystemExit):
        cli.main(["fit", "--target", *paths, "--method", "mcs",
                  "--grid", "8", "--steps", "1", "-o", str(out)])

    # --inpaint completes the fit's occluded set post-hoc (cli wires
    # vpt_jax.inpaint.complete_occluded; forensics in
    # docs/ARCHITECTURE.md "Occlusion completion")
    out2 = tmp_path / "vol_inpaint"
    cli.main(["fit", "--target", *paths, "--view-yaw", "0", "180",
              "--grid", "8", "--steps", "3", "--eam-slices", "16",
              "--inpaint", "--inpaint-tau", "0.15", "-o", str(out2)])
    completed = np.load(str(out2) + ".npy")
    assert completed.shape == (8, 8, 8, 1)
    assert completed.min() >= 0.0 and completed.max() <= 1.0


def test_cli_fit_iso_depth(tmp_path):
    from vpt_jax import cli, transfer, volume
    from vpt_jax.renderers import diff_iso, make_scene

    truth = volume.sphere_volume(8)
    tf = transfer.gray_ramp(alpha_scale=1.0)
    scene = make_scene(truth.data, tf, pack=False)
    depth = diff_iso.render(scene, diff_iso.Params(), 12, 12)["depth"]
    target = tmp_path / "depth.npy"
    np.save(target, np.asarray(depth))

    out = tmp_path / "vol"
    cli.main(["fit", "--target", str(target), "--method", "iso-depth",
              "--grid", "8", "--steps", "2", "-o", str(out)])
    assert np.load(str(out) + ".npy").shape == (8, 8, 8, 1)

    # non-.npy targets get a clean error, not a traceback
    bogus = tmp_path / "depth.png"
    bogus.write_bytes(b"")
    with pytest.raises(SystemExit):
        cli.main(["fit", "--target", str(bogus), "--method", "iso-depth",
                  "--grid", "8", "--steps", "1", "-o", str(out)])


def test_cli_info_volume_rejects_non_archives(tmp_path):
    from vpt_jax import cli

    with pytest.raises(SystemExit):
        cli.main(["info", "--volume", str(tmp_path / "vol.raw")])
    with pytest.raises(SystemExit):
        cli.main(["info", "--volume", str(tmp_path / "missing.bvp")])


def test_distributed_single_process():
    from vpt_jax.parallel import distributed

    assert distributed.initialize() is False  # no coordinator configured
    assert "devices" in distributed.topology_summary()
