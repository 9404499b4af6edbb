"""Offline viewer — the reference's "view mode" (src/viewer.ts, the rAF loop
in src/main.ts:537-608) re-imagined for a headless GPU host: load a splat,
fly/orbit a camera, render frames to arrays or PNG files.
"""

from __future__ import annotations

import math
import os

import numpy as np

from webdgs.config import (DEFAULT_SETTINGS, RenderSettings,
                                quantize_budget)
from webdgs.core.camera import Camera, CameraData, make_camera
from webdgs.core.scene import GaussianScene
from webdgs.render.camera_control import FlyCamera
from webdgs.render.renderer import (render_banded, render_compiled,
                                        render_points_compiled)


def save_png(path: str | os.PathLike, image: np.ndarray) -> None:
    from PIL import Image
    arr = np.clip(np.asarray(image), 0.0, 1.0)
    Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)


def look_at_rotation(position: np.ndarray, target: np.ndarray,
                     up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World-to-camera rotation looking from position toward target, with
    the framework's +z-forward view convention."""
    fwd = np.asarray(target, np.float64) - np.asarray(position, np.float64)
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-8:
        right = np.array([1.0, 0.0, 0.0])
        nr = 1.0
    right = right / nr
    true_up = np.cross(fwd, right)
    return np.stack([right, true_up, fwd]).astype(np.float32)


class Viewer:
    """Render a scene interactively-by-script: a FlyCamera plus render()."""

    def __init__(self, scene: GaussianScene, width: int = 800,
                 height: int = 600,
                 settings: RenderSettings = DEFAULT_SETTINGS,
                 fov_y_deg: float = 45.0,
                 render_mode: str = "gaussian",
                 point_size_px: float = 3.0):
        self.scene = scene
        self.width = width
        self.height = height
        self.settings = settings
        self.fov_y = math.radians(fov_y_deg)
        self.control = FlyCamera(position=(0.0, 0.0, 5.0))
        # reference viewer setters (src/viewer.ts:90-100)
        self.render_mode = render_mode  # 'gaussian' | 'pointcloud'
        self.point_size_px = point_size_px
        # live knobs passed to the render as TRACED scalars — stepping
        # them must not recompile the pipeline (render_compiled notes)
        self.gaussian_scaling = float(settings.gaussian_scaling)
        # adaptive tile-entry capacity, like the Trainer: sized from the
        # first frame's observed entry count (one recompile when it changes)
        self._entry_cap: int | None = None

    def set_render_mode(self, mode: str) -> None:
        if mode not in ("gaussian", "pointcloud"):
            raise ValueError(f"unknown render mode {mode!r}")
        self.render_mode = mode

    def set_point_size(self, value: float) -> None:
        self.point_size_px = float(value)

    def set_gaussian_scaling(self, value: float) -> None:
        """The reference's Gaussian-scale slider (main.ts:369-372)."""
        self.gaussian_scaling = max(0.05, float(value))

    def set_point_cloud(self, scene: GaussianScene) -> None:
        self.scene = scene

    def frame_scene(self) -> None:
        """Place the camera to frame the alive-point centroid (the
        reference resets to a fixed (0,0,5) which faces away from
        origin-centered scenes; this default actually shows the data)."""
        means = np.asarray(self.scene.means)
        alive = np.asarray(self.scene.alive)
        pts = means[alive] if alive.any() else means
        center = pts.mean(axis=0)
        radius = float(np.percentile(
            np.linalg.norm(pts - center, axis=1), 90) * 2.5 + 1e-3)
        pos = center - np.array([0.0, 0.0, radius], np.float32)
        self.control.position = pos.astype(np.float32)
        # look_at_rotation is y-up; the framework's projection maps +y_view
        # to increasing image row (COLMAP-style), so roll 180 degrees
        # (negate the x and y camera axes — still a proper rotation) to get
        # upright frames
        rot = look_at_rotation(pos, center)
        self.control.rotation = np.stack([-rot[0], -rot[1], rot[2]])

    def camera(self, width: int | None = None,
               height: int | None = None) -> Camera:
        w = width or self.width
        h = height or self.height
        # fovY is preserved at any viewport; focal re-derives from height
        # exactly like the reference's resize handling (camera.ts:138-146)
        fy = 0.5 * h / math.tan(self.fov_y * 0.5)
        data = CameraData(position=self.control.position,
                          rotation=self.control.rotation,
                          fy=fy, height=h)
        return make_camera(data, w, h)

    def render(self, downscale: int = 1) -> np.ndarray:
        """Render a frame; ``downscale`` > 1 renders at a reduced viewport
        (same fov), for cheap frames during camera motion."""
        w = max(1, self.width // downscale)
        h = max(1, self.height // downscale)
        cam = self.camera(w, h)
        gsc = np.float32(self.gaussian_scaling)
        from webdgs.ops import binning as binning_ops
        ntx, nty = binning_ops.tile_grid(w, h, self.settings)
        if ntx * nty >= binning_ops.TILE_KEY_LIMIT:
            # above the 16-bit tile-key ceiling (4K+ frames): serial bands.
            # Both modes route here — pointcloud through the plain path
            # would raise check_tile_key_limit (ADVICE r4).
            img, observed = render_banded(
                self.scene, cam, w, h, self.settings,
                entry_capacity=self._entry_cap, gaussian_scaling=gsc,
                mode=self.render_mode,
                point_size_px=np.float32(self.point_size_px),
                return_entries=True)
            # adapt to the max per-band demand: the banded path serves
            # exactly the always-above-ceiling viewports where the plain
            # branch's adaptation never runs (ADVICE r4 medium).  Like the
            # plain branch, only full-resolution frames adapt — a motion-
            # downscaled frame's smaller demand must not shrink the cap
            # out from under the next full frame.
            if observed is not None and downscale == 1:
                self._adapt_entry_cap(int(observed))
            return np.asarray(img)
        if self.render_mode == "pointcloud":
            img = render_points_compiled(
                self.scene, cam, img_w=w, img_h=h, settings=self.settings,
                point_size_px=np.float32(self.point_size_px),
                gaussian_scaling=gsc)
            return np.asarray(img)
        res = render_compiled(self.scene, cam, img_w=w, img_h=h,
                              settings=self.settings,
                              entry_capacity=self._entry_cap,
                              gaussian_scaling=gsc)
        if downscale == 1:
            # expansion_entries, not total_entries: the latter saturates
            # at the current capacity under overflow drops, so adaptation
            # must observe the pre-drop demand to see real pressure
            self._adapt_entry_cap(int(res.binning.expansion_entries))
        return np.asarray(res.image)

    def _adapt_entry_cap(self, observed: int) -> None:
        chunk = self.settings.chunk
        # rung-quantized (geometric ladder): every distinct capacity is
        # a fresh render compile — a slowly growing scene (live
        # training) must not recompile the viewer every few frames
        want = quantize_budget(observed * 1.5, chunk, chunk * 8)
        if self._entry_cap is None or want > self._entry_cap or \
                want < self._entry_cap // 3:
            self._entry_cap = want


def orbit_cameras(center, radius: float, n_frames: int, width: int,
                  height: int, elevation_deg: float = 15.0,
                  fov_y_deg: float = 45.0) -> list[Camera]:
    center = np.asarray(center, np.float32)
    el = math.radians(elevation_deg)
    fy = 0.5 * height / math.tan(math.radians(fov_y_deg) * 0.5)
    cams = []
    for i in range(n_frames):
        az = 2.0 * math.pi * i / n_frames
        pos = center + radius * np.array([
            math.cos(el) * math.sin(az),
            math.sin(el),
            math.cos(el) * math.cos(az)], np.float32)
        rot = look_at_rotation(pos, center)
        cams.append(make_camera(CameraData(position=pos, rotation=rot,
                                           fy=fy, height=height),
                                width, height))
    return cams


def render_orbit(scene: GaussianScene, out_dir: str | os.PathLike,
                 n_frames: int = 24, width: int = 800, height: int = 600,
                 settings: RenderSettings = DEFAULT_SETTINGS,
                 radius: float | None = None) -> list[str]:
    """Render an orbit around the alive-point centroid to PNG frames."""
    means = np.asarray(scene.means)
    alive = np.asarray(scene.alive)
    pts = means[alive] if alive.any() else means
    center = pts.mean(axis=0)
    if radius is None:
        radius = float(np.percentile(
            np.linalg.norm(pts - center, axis=1), 90) * 2.5 + 1e-3)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, cam in enumerate(orbit_cameras(center, radius, n_frames,
                                          width, height)):
        img = render_compiled(scene, cam, img_w=width, img_h=height,
                              settings=settings).image
        p = os.path.join(out_dir, f"frame_{i:04d}.png")
        save_png(p, np.asarray(img))
        paths.append(p)
    return paths


def frames_to_video(frame_paths: list[str], out_path: str | os.PathLike,
                    fps: int = 12) -> str:
    """Encode rendered frames into a video file.

    ``.gif`` encodes with PIL (always available); any other extension is
    handed to ``ffmpeg`` when present, else falls back to ``<out>.gif``.
    The reference's viewer is live-only (rAF loop, src/main.ts:537-608) —
    this is the headless counterpart for sharing a turntable capture.
    """
    out_path = str(out_path)
    if not frame_paths:
        raise ValueError("no frames to encode")
    if not out_path.lower().endswith(".gif"):
        import shutil
        import subprocess
        import tempfile
        if shutil.which("ffmpeg"):
            # feed the EXACT frame list via the concat demuxer — a
            # frame_%04d.png glob would silently sweep up stale frames
            # from a previous longer orbit in the same directory
            with tempfile.NamedTemporaryFile(
                    "w", suffix=".txt", delete=False) as lf:
                for fp in frame_paths:
                    lf.write(f"file '{os.path.abspath(fp)}'\n")
                    lf.write(f"duration {1.0 / fps}\n")
                list_path = lf.name
            try:
                subprocess.run(
                    ["ffmpeg", "-y", "-loglevel", "error", "-f", "concat",
                     "-safe", "0", "-i", list_path, "-vf", f"fps={fps}",
                     "-pix_fmt", "yuv420p", out_path], check=True)
            finally:
                os.unlink(list_path)
            return out_path
        out_path = os.path.splitext(out_path)[0] + ".gif"
    from PIL import Image
    frames = [Image.open(p).convert("P", palette=Image.ADAPTIVE)
              for p in frame_paths]
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=max(1, round(1000 / fps)), loop=0)
    return out_path
