"""Densification importance metrics.

Replaces the reference's three metric kernels (src/shaders/metric-map.wgsl,
metric-count.wgsl, metric-normalize.wgsl) and fixes its single-camera-buffer
bug (SURVEY.md Q1: all encoded metric views rendered with the LAST camera,
because every set_preset writeBuffer lands before the one submit; here each
view really renders with its own camera).

Pipeline per view, at a downscaled resolution (metricDownscale, default 2):
  1. render the scene; keep the per-tile n_contrib map,
  2. error map = mean |pred - gt| per pixel, min/max-normalized, thresholded
     to a binary flag map (metric-map.wgsl:27-117),
  3. for each flagged pixel, count every entry in the first n_contrib
     positions of its tile whose alpha >= 1/255 toward that entry's Gaussian
     (metric-count.wgsl:55-88) — computed per ENTRY: the entry's count is
     the sum over its tile's pixels of flag * [alpha >= 1/255] *
     [position <= n_contrib], in blocks of entries under ``lax.map`` so
     memory stays bounded, then scatter-added per Gaussian (exact: the
     counts are small integers),
  4. counts accumulate over views and divide by the view count
     (metric-normalize.wgsl).

This runs only at densify events, off the per-step path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from webdgs.config import RenderSettings
from webdgs.core.camera import Camera
from webdgs.ops import binning as binning_ops
from webdgs.ops import rasterize as raster_ops
from webdgs.ops.projection import project_gaussians

# entries per lax.map block: bounds the (block, P) working set
ENTRY_BLOCK = 4096


def metric_flag_map(pred: jax.Array, target: jax.Array,
                    threshold: float) -> jax.Array:
    """Binary (H, W) importance mask (metric-map.wgsl)."""
    err = jnp.mean(jnp.abs(pred - target), axis=-1)
    lo, hi = jnp.min(err), jnp.max(err)
    norm = jnp.where(hi > lo, (err - lo) / jnp.maximum(hi - lo, 1e-12), 0.0)
    return (norm > threshold).astype(jnp.float32)


def entry_counts(attrs16, bins: binning_ops.Binning, pix_tiles, ntx: int,
                 settings: RenderSettings) -> jax.Array:
    """(E,) replay count of every sorted entry slot (0 for invalid slots).

    ``pix_tiles``: (T, P, 2) per-tile pixel columns [flag, n_contrib]."""
    e_cap = bins.capacity
    blk = min(ENTRY_BLOCK, e_cap)
    n_blk = -(-e_cap // blk)
    pad = n_blk * blk - e_cap
    tile = jnp.where(bins.entry_valid, bins.entry_tile, 0)
    # 1-based position of each entry within its tile's range
    pos = (jnp.arange(e_cap, dtype=jnp.int32) + 1
           - bins.tile_offsets[tile]).astype(jnp.float32)
    rows = jnp.pad(attrs16, ((0, 0), (0, pad))).T.reshape(
        n_blk, blk, raster_ops.NUM_ROWS)
    tile = jnp.pad(tile, (0, pad)).reshape(n_blk, blk)
    pos = jnp.pad(pos, (0, pad)).reshape(n_blk, blk)
    valid = jnp.pad(bins.entry_valid, (0, pad)).reshape(n_blk, blk)

    def one(entry, t, p):
        # the (P, 1)-pixel x (1, 1)-entry form of the rasterizer's alpha
        pxf, pyf = raster_ops._pixel_coords(t, ntx, settings)
        alpha, _, _, _ = raster_ops.chunk_alpha(
            [entry[r][None, None] for r in range(raster_ops.NUM_ROWS)],
            True, pxf, pyf, settings)
        flag = pix_tiles[t, :, 0:1]
        n_contrib = pix_tiles[t, :, 1:2]
        hit = (alpha >= settings.alpha_min) & (p <= n_contrib) & (flag > 0.0)
        return jnp.sum(hit.astype(jnp.float32))

    def block(args):
        r, t, p, v = args
        return jnp.where(v, jax.vmap(one)(r, t, p), 0.0)

    counts = jax.lax.map(block, (rows, tile, pos, valid))
    return counts.reshape(-1)[:e_cap]


def view_importance_counts(scene_params, alive, sh_deg, camera: Camera,
                           target: jax.Array, img_w: int, img_h: int,
                           threshold: float,
                           settings: RenderSettings) -> jax.Array:
    """Per-Gaussian importance counts for one view (already downscaled).

    target: (img_h, img_w, 3) ground truth at the metrics resolution.
    """
    attrs, aux = project_gaussians(scene_params, alive, camera, img_w, img_h,
                                   sh_deg, settings)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    # attrs enables the exact tile cull (binning.expand_entries): culled
    # pairs have alpha < alpha_min at every pixel, so they are never
    # contributors — n_contrib and the replayed counts are unchanged
    bins = binning_ops.bin_splats(aux, img_w, img_h, settings, attrs=attrs)
    attrs16 = raster_ops.pack_entry_attrs(attrs, bins.entry_gauss,
                                          bins.entry_valid)
    out = raster_ops.rasterize_tiles(attrs16, bins.tile_offsets, ntx, nty,
                                     settings)
    tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h, settings)
    pred = raster_ops.composite_background(tiles, settings)

    flag = metric_flag_map(pred, target, threshold)
    pix = jnp.stack([flag, tiles[..., raster_ops.OUT_NCONTRIB]], axis=-1)
    pix_tiles = raster_ops.image_to_tiles(pix, ntx, nty, settings)

    counts = entry_counts(attrs16, bins, pix_tiles, ntx, settings)
    return jnp.zeros((alive.shape[0],), jnp.float32).at[
        bins.entry_gauss].add(counts)


def multiview_importance_counts(scene_params, alive, sh_deg,
                                cameras: Camera, targets: jax.Array,
                                img_w: int, img_h: int, threshold: float,
                                settings: RenderSettings) -> jax.Array:
    """Average counts over a batch of views (leading axis on cameras/targets),
    the reference's multi-view accumulation + normalize (trainer.ts:391-432)
    with Q1 fixed."""
    n_views = targets.shape[0]

    def body(i, acc):
        cam_i = jax.tree.map(lambda x: x[i], cameras)
        return acc + view_importance_counts(
            scene_params, alive, sh_deg, cam_i, targets[i], img_w, img_h,
            threshold, settings)

    total = jax.lax.fori_loop(
        0, n_views, body, jnp.zeros((alive.shape[0],), jnp.float32))
    return total / n_views
