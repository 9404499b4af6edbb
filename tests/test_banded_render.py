"""Serial-band rendering above the 16-bit tile-key ceiling.

The reference's key layout caps tile ids at 16 bits
(src/shaders/tiled-forward.wgsl:133-136) and has no fallback; the
single-chip banded renderer must produce pixel-identical frames to the
plain path while never building a band above the ceiling.
"""

import numpy as np
import pytest

from webdgs.config import DEFAULT_SETTINGS
from webdgs.core.camera import default_camera
from webdgs.ops import binning as binning_ops
from webdgs.render.renderer import render, render_banded

from tests.test_render_forward import random_scene


def _camera(w, h):
    return default_camera(w, h, position=(0.0, 0.0, -5.0))


@pytest.mark.parametrize("bands", [2, 3])
def test_banded_matches_plain(bands):
    scene = random_scene(97, seed=11)
    w, h = 64, 96
    cam = _camera(w, h)
    ref = np.asarray(render(scene, cam, w, h, DEFAULT_SETTINGS).image)
    got = np.asarray(render_banded(scene, cam, w, h, DEFAULT_SETTINGS,
                                   bands=bands))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_banded_auto_single_band_is_plain():
    scene = random_scene(50, seed=3)
    w, h = 64, 48
    cam = _camera(w, h)
    ref = np.asarray(render(scene, cam, w, h, DEFAULT_SETTINGS).image)
    got = np.asarray(render_banded(scene, cam, w, h, DEFAULT_SETTINGS))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_band_count_math():
    """Auto band count keeps every band under the ceiling and covers the
    grid, including a 7680x4320 (8K) frame at 16x16 tiles (129,600 tiles —
    double the ceiling; raises in the plain path today)."""
    import dataclasses
    s = dataclasses.replace(DEFAULT_SETTINGS, tile_w=16, tile_h=16)
    for w, h in [(7680, 4320), (4096, 4096), (3840, 2160)]:
        ntx, nty = binning_ops.tile_grid(w, h, s)
        rows_max = max(0xFFFE // ntx, 1)
        bands = -(-nty // rows_max)
        rows = -(-nty // bands)
        assert ntx * rows < 0xFFFF
        assert bands * rows >= nty
        if ntx * nty >= 0xFFFF:
            assert bands > 1
            with pytest.raises(ValueError):
                binning_ops.check_tile_key_limit(ntx * nty)


def test_banded_nonuniform_last_band():
    """Band rows that do not divide the grid evenly: the tail band is
    padded and cropped, not wrapped."""
    scene = random_scene(64, seed=7)
    w, h = 64, 80  # nty=5 tile rows at 16 -> bands of 2 rows, last has 1
    cam = _camera(w, h)
    ref = np.asarray(render(scene, cam, w, h, DEFAULT_SETTINGS).image)
    got = np.asarray(render_banded(scene, cam, w, h, DEFAULT_SETTINGS,
                                   bands=3))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_banded_pointcloud_matches_plain():
    """Pointcloud debug mode through the banded path (the plain path raises
    check_tile_key_limit above the ceiling; ADVICE r4 low #2)."""
    from webdgs.render.renderer import render_points
    scene = random_scene(80, seed=5)
    w, h = 64, 96
    cam = _camera(w, h)
    ref = np.asarray(render_points(scene, cam, w, h, DEFAULT_SETTINGS,
                                   point_size_px=3.0))
    got = np.asarray(render_banded(scene, cam, w, h, DEFAULT_SETTINGS,
                                   bands=3, mode="pointcloud",
                                   point_size_px=3.0))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_banded_return_entries():
    """return_entries reports the max per-band pre-drop demand so adaptive
    callers can size capacity from banded frames (ADVICE r4 medium)."""
    scene = random_scene(97, seed=11)
    w, h = 64, 96
    cam = _camera(w, h)
    img, ent = render_banded(scene, cam, w, h, DEFAULT_SETTINGS,
                             bands=2, return_entries=True)
    assert img.shape == (h, w, 3)
    assert int(ent) > 0
    # single-band degenerate case also reports demand
    img1, ent1 = render_banded(scene, cam, w, h, DEFAULT_SETTINGS,
                               bands=1, return_entries=True)
    assert int(ent1) >= int(ent) // 2  # same frame, one band covers all


def test_viewer_banded_branch_adapts_capacity(monkeypatch):
    """With the tile-key ceiling lowered, the Viewer routes through the
    banded path and still adapts _entry_cap (ADVICE r4 medium: the banded
    branch previously returned before adaptation), and pointcloud mode
    renders instead of raising (ADVICE r4 low)."""
    from webdgs.ops import binning as binning_ops
    from webdgs.render.viewer import Viewer

    scene = random_scene(64, seed=9)
    w, h = 64, 96  # 4x6 = 24 tiles at 16px
    monkeypatch.setattr(binning_ops, "TILE_KEY_LIMIT", 13)
    v = Viewer(scene, width=w, height=h)
    v.frame_scene()
    img = v.render()
    assert img.shape == (h, w, 3)
    assert v._entry_cap is not None and v._entry_cap > 0
    cap = v._entry_cap
    # banded pointcloud mode does not crash at above-ceiling viewports
    v.set_render_mode("pointcloud")
    img2 = v.render()
    assert img2.shape == (h, w, 3)
    assert v._entry_cap == cap  # pointcloud bands use the same cap
