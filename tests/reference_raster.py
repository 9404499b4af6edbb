"""Slow sequential NumPy oracle for the tile rasterizer.

Implements, with explicit per-pixel loops, the compositing semantics
documented from the reference (see webdgs/ops/rasterize.py docstring):
front-to-back alpha blending in tile/depth order, 0.99 alpha clamp, 1/255
contribution threshold, early termination at accumulated alpha > 0.99,
SnugBox extent test, last-contributor tracking.
"""

from __future__ import annotations

import numpy as np


def composite_pixel(px, py, entries, alpha_min=1.0 / 255.0, alpha_max=0.99,
                    t_threshold=0.01):
    """entries: iterable of dicts with center, conic, color, opacity,
    extents, in depth order. Returns (rgb, accum_alpha, T, n_contrib)."""
    accum = np.zeros(3)
    t = 1.0
    n_contrib = 0
    for j, e in enumerate(entries):
        if t < t_threshold:
            break
        dx = px - e["center"][0]
        dy = py - e["center"][1]
        if abs(dx) > e["extents"][0] or abs(dy) > e["extents"][1]:
            continue
        ca, cb, cc = e["conic"]
        power = ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy
        g = np.exp(-0.5 * power)
        alpha = min(alpha_max, e["opacity"] * g)
        if alpha < alpha_min:
            continue
        accum = accum + np.asarray(e["color"]) * alpha * t
        t = t * (1.0 - alpha)
        n_contrib = j + 1
    return accum, 1.0 - t, t, n_contrib


def render_reference(attrs, sorted_gauss, entry_valid, tile_offsets,
                     num_tiles_x, num_tiles_y, img_w, img_h,
                     tile_w=16, tile_h=16, background=(0.0, 0.0, 0.0)):
    """Render the full image with python loops. attrs fields are numpy
    arrays indexed by gaussian."""
    out = np.zeros((img_h, img_w, 3))
    t_map = np.ones((img_h, img_w))
    nc_map = np.zeros((img_h, img_w), dtype=np.int64)
    bg = np.asarray(background)
    for ty in range(num_tiles_y):
        for tx in range(num_tiles_x):
            tid = ty * num_tiles_x + tx
            lo, hi = int(tile_offsets[tid]), int(tile_offsets[tid + 1])
            entries = []
            for e in range(lo, hi):
                if not entry_valid[e]:
                    continue
                g = int(sorted_gauss[e])
                entries.append({
                    "center": attrs["center_px"][g],
                    "conic": attrs["conic"][g],
                    "color": attrs["color"][g],
                    "opacity": attrs["opacity"][g],
                    "extents": attrs["extents"][g],
                })
            for ly in range(tile_h):
                for lx in range(tile_w):
                    x = tx * tile_w + lx
                    y = ty * tile_h + ly
                    if x >= img_w or y >= img_h:
                        continue
                    rgb, _, t, nc = composite_pixel(x + 0.5, y + 0.5, entries)
                    out[y, x] = rgb + bg * t
                    t_map[y, x] = t
                    nc_map[y, x] = nc
    return out, t_map, nc_map
