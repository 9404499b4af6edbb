"""IO loaders: PLY round-trip, COLMAP binaries, JSON cameras, checkpoints."""

import json
import struct

import numpy as np

from webdgs.core.camera import make_camera
from webdgs.io.checkpoint import load_checkpoint, save_checkpoint
from webdgs.io.colmap import (load_cameras, load_cameras_bin,
                                  load_images_bin, quat_to_rotmat_wxyz)
from webdgs.io.images import numeric_key
from webdgs.io.ply import load_ply, load_point_cloud, save_ply
from webdgs.ops.adam import init_adam_state

from tests.test_render_forward import random_scene


def make_full_ply_bytes(n=5, sh_deg=2, seed=0):
    """Hand-build a 'full' 3DGS PLY for parser testing."""
    rng = np.random.default_rng(seed)
    n_per = (sh_deg + 1) ** 2 - 1
    fields = (["x", "y", "z"] + [f"f_dc_{j}" for j in range(3)]
              + [f"f_rest_{i}" for i in range(3 * n_per)]
              + ["opacity"] + [f"scale_{i}" for i in range(3)]
              + [f"rot_{i}" for i in range(4)])
    data = rng.normal(0, 1, (n, len(fields))).astype(np.float32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {f}" for f in fields]
    header += ["end_header", ""]
    return ("\n".join(header)).encode() + data.tobytes(), fields, data


def test_ply_full_parse():
    blob, fields, data = make_full_ply_bytes(sh_deg=2)
    scene = load_ply(blob)
    assert scene.sh_deg == 2
    fi = {f: i for i, f in enumerate(fields)}
    np.testing.assert_allclose(np.asarray(scene.means)[:, 0], data[:, fi["x"]])
    np.testing.assert_allclose(np.asarray(scene.opacity_logits),
                               data[:, fi["opacity"]])
    np.testing.assert_allclose(np.asarray(scene.quats)[:, 3],
                               data[:, fi["rot_3"]])
    # SH layout: f_rest channel-major blocks (load-pointcloud.ts:184-192)
    n_per = 8
    sh = np.asarray(scene.sh)
    np.testing.assert_allclose(sh[:, 0, 1], data[:, fi["f_dc_1"]])
    np.testing.assert_allclose(sh[:, 3, 2],
                               data[:, fi[f"f_rest_{2 * n_per + 2}"]])
    np.testing.assert_allclose(sh[:, 9:, :], 0.0)  # beyond deg 2: zero


def test_ply_normal_parse_uchar_colors():
    n = 4
    rng = np.random.default_rng(1)
    xyz = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z",
              "property uchar red", "property uchar green",
              "property uchar blue", "end_header", ""]
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rows = np.zeros(n, dtype=dtype)
    rows["x"], rows["y"], rows["z"] = xyz.T
    rows["red"], rows["green"], rows["blue"] = rgb.T
    scene = load_ply("\n".join(header).encode() + rows.tobytes())
    assert scene.sh_deg == 0
    c0 = 0.28209479177387814
    expect_dc = (rgb.astype(np.float32) / 255.0 - 0.5) / c0
    np.testing.assert_allclose(np.asarray(scene.sh)[:, 0, :], expect_dc,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(scene.log_scales), -5.0)
    np.testing.assert_allclose(np.asarray(scene.opacity_logits), 1.0)


def test_ply_roundtrip(tmp_path):
    scene = random_scene(20, seed=2, sh_deg=3)
    p = tmp_path / "out.ply"
    n = save_ply(scene, p)
    assert n == 20
    back = load_point_cloud(p)
    assert back.sh_deg == 3
    np.testing.assert_allclose(np.asarray(back.means),
                               np.asarray(scene.means), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(back.sh), np.asarray(scene.sh),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(back.quats),
                               np.asarray(scene.quats), rtol=1e-6)


def test_points3d_bin():
    n = 3
    buf = struct.pack("<Q", n)
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 1, (n, 3))
    cols = rng.integers(0, 256, (n, 3))
    for i in range(n):
        track_len = int(rng.integers(0, 5))
        buf += struct.pack("<Q", i + 1)
        buf += struct.pack("<3d", *pts[i])
        buf += struct.pack("<3B", *cols[i])
        buf += struct.pack("<d", 0.5)
        buf += struct.pack("<Q", track_len)
        buf += b"\x00" * (track_len * 8)
    scene = load_point_cloud(buf)
    np.testing.assert_allclose(np.asarray(scene.means), pts, rtol=1e-5)
    c0 = 0.28209479177387814
    np.testing.assert_allclose(
        np.asarray(scene.sh)[:, 0, :], (cols / 255.0 - 0.5) / c0, rtol=1e-4,
        atol=1e-4)


def _images_bin_bytes(entries):
    buf = struct.pack("<Q", len(entries))
    for e in entries:
        buf += struct.pack("<I", e["id"])
        buf += struct.pack("<7d", *e["qvec"], *e["tvec"])
        buf += struct.pack("<I", e["camera_id"])
        buf += e["name"].encode() + b"\x00"
        buf += struct.pack("<Q", 0)
    return buf


def _cameras_bin_bytes(entries):
    buf = struct.pack("<Q", len(entries))
    for e in entries:
        buf += struct.pack("<Ii2Q", e["id"], e["model"], e["w"], e["h"])
        buf += struct.pack(f"<{len(e['params'])}d", *e["params"])
    return buf


def test_colmap_merge(tmp_path):
    q = (0.9238795, 0.0, 0.3826834, 0.0)  # 45 deg about y
    t = (1.0, 2.0, 3.0)
    img_blob = _images_bin_bytes([
        {"id": 7, "qvec": q, "tvec": t, "camera_id": 2, "name": "b.png"}])
    cam_blob = _cameras_bin_bytes([
        {"id": 2, "model": 1, "w": 640, "h": 480,
         "params": [500.0, 510.0, 320.0, 240.0]}])
    (tmp_path / "images.bin").write_bytes(img_blob)
    (tmp_path / "cameras.bin").write_bytes(cam_blob)
    cams = load_cameras([tmp_path / "images.bin", tmp_path / "cameras.bin"])
    assert len(cams) == 1
    c = cams[0]
    assert c.img_name == "b.png" and c.fx == 500.0 and c.fy == 510.0
    assert c.width == 640 and c.height == 480
    r = quat_to_rotmat_wxyz(*q)
    np.testing.assert_allclose(c.rotation, r, atol=1e-6)
    np.testing.assert_allclose(c.position, -(r.T @ np.asarray(t)), atol=1e-5)
    # builds a device camera
    cam = make_camera(c)
    assert cam.view.shape == (4, 4)


def test_colmap_unsupported_model():
    blob = _cameras_bin_bytes([
        {"id": 1, "model": 4, "w": 10, "h": 10,
         "params": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]}])
    try:
        load_cameras_bin(blob)
        assert False, "should raise on OPENCV model"
    except ValueError as e:
        assert "model" in str(e)


def test_cameras_json(tmp_path):
    entry = {"id": 1, "img_name": "x.png", "width": 100, "height": 80,
             "position": [1, 2, 3],
             "rotation": [[1, 0, 0], [0, 0, -1], [0, 1, 0]],
             "fx": 90.0, "fy": 95.0}
    p = tmp_path / "cameras.json"
    p.write_text(json.dumps([entry]))
    cams = load_cameras(p)
    assert len(cams) == 1 and cams[0].fy == 95.0
    np.testing.assert_allclose(cams[0].rotation,
                               np.asarray(entry["rotation"]))


def test_numeric_name_sort():
    names = ["img10.png", "img2.png", "img1.png"]
    assert sorted(names, key=numeric_key) == \
        ["img1.png", "img2.png", "img10.png"]


def test_checkpoint_roundtrip(tmp_path):
    scene = random_scene(10, seed=4, sh_deg=1)
    opt = init_adam_state(scene.params())
    p = tmp_path / "ckpt.npz"
    save_checkpoint(p, scene, opt, iteration=123)
    back, opt2, meta = load_checkpoint(p)
    assert meta["iteration"] == 123 and back.sh_deg == 1
    np.testing.assert_allclose(np.asarray(back.means),
                               np.asarray(scene.means))
    assert opt2 is not None
    np.testing.assert_allclose(np.asarray(opt2.m), np.asarray(opt.m))


def test_native_parser_matches_python():
    """The C++ fast path must agree byte-for-byte with the Python parsers."""
    from webdgs.io import native
    if native.get_lib() is None:
        import pytest
        pytest.skip("no C++ toolchain available")

    rng = np.random.default_rng(44)
    # points3D with variable tracks
    n = 50
    buf = struct.pack("<Q", n)
    for i in range(n):
        tl = int(rng.integers(0, 7))
        buf += struct.pack("<Q", i)
        buf += struct.pack("<3d", *rng.normal(0, 2, 3))
        buf += struct.pack("<3B", *rng.integers(0, 256, 3))
        buf += struct.pack("<d", 0.1)
        buf += struct.pack("<Q", tl) + b"\x01" * (tl * 8)
    fast = native.parse_points3d(buf)
    assert fast is not None
    scene = load_point_cloud(buf)  # goes through the native path
    np.testing.assert_allclose(np.asarray(scene.means), fast[0])

    # pure python path for comparison
    from webdgs.io.ply import scene_from_arrays  # noqa: F401
    import webdgs.io.ply as plymod
    import webdgs.io.native as nat

    orig = nat.parse_points3d
    try:
        nat.parse_points3d = lambda data: None
        scene_py = plymod.load_points3d_bin(buf)
    finally:
        nat.parse_points3d = orig
    np.testing.assert_allclose(np.asarray(scene.means),
                               np.asarray(scene_py.means), atol=1e-6)
    np.testing.assert_allclose(np.asarray(scene.sh),
                               np.asarray(scene_py.sh), atol=1e-6)

    # images.bin
    entries = [{"id": 3, "qvec": (0.7, 0.1, -0.3, 0.2),
                "tvec": (0.5, -1.0, 2.0), "camera_id": 9,
                "name": "img_007.png"},
               {"id": 5, "qvec": (1.0, 0.0, 0.0, 0.0),
                "tvec": (0.0, 0.0, 0.0), "camera_id": 9, "name": "x.png"}]
    blob = _images_bin_bytes(entries)
    from webdgs.io.colmap import load_images_bin
    cams_native = load_images_bin(blob)
    orig2 = nat.parse_images_bin
    try:
        nat.parse_images_bin = lambda data: None
        cams_py = load_images_bin(blob)
    finally:
        nat.parse_images_bin = orig2
    assert len(cams_native) == len(cams_py) == 2
    for a, b in zip(cams_native, cams_py):
        assert a.id == b.id and a.img_name == b.img_name
        np.testing.assert_allclose(a.rotation, b.rotation, atol=1e-6)
        np.testing.assert_allclose(a.position, b.position, atol=1e-5)


def test_synthetic_colmap_roundtrip(tmp_path):
    """The dataset generator's binary writers and the framework loaders are
    a writer/reader pair: poses, intrinsics, and points must round-trip
    byte-level through real images.bin/cameras.bin/points3D.bin files."""
    import subprocess
    import sys

    import numpy as np

    out = tmp_path / "scene"
    r = subprocess.run(
        [sys.executable, "scripts/make_synthetic_colmap.py", str(out),
         "--views", "3", "--width", "48", "--height", "36",
         "--points", "200"],
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr

    from webdgs.io.colmap import load_cameras
    from webdgs.io.ply import load_point_cloud

    cams = load_cameras([str(out / "sparse/0/images.bin"),
                         str(out / "sparse/0/cameras.bin")])
    assert len(cams) == 3
    for c in cams:
        assert c.width == 48 and c.height == 36
        assert abs(c.fx - c.fy) < 1e-9
        # w2c rotation is orthonormal with det +1 after the quat round-trip
        np.testing.assert_allclose(c.rotation @ c.rotation.T, np.eye(3),
                                   atol=1e-5)
        assert np.linalg.det(c.rotation) > 0.99
        # the generator orbits at radius ~4.5 around (0,-0.3,0)
        assert 3.5 < np.linalg.norm(c.position - [0, -0.3, 0]) < 5.5

    scene = load_point_cloud(str(out / "sparse/0/points3D.bin"))
    n = int(scene.num_alive())
    assert 50 <= n <= 200
    means = np.asarray(scene.means)[:n]
    assert np.isfinite(means).all()
    # surface samples live in the scene bounding volume (sky excluded)
    assert np.abs(means).max() < 8.0

    imgs = sorted((out / "images").iterdir())
    assert len(imgs) == 3 and all(p.suffix == ".png" for p in imgs)
