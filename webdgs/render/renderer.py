"""Full forward render: scene + camera -> image.

Equivalent to the reference's per-frame encode of TiledForwardPass +
TiledRasterizer (src/viewer.ts:71-100, src/renderers/tiled-forward-pass.ts:
341-404, src/renderers/tiled-rasterizer.ts:180-300), as one jittable
function.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from webdgs.config import DEFAULT_SETTINGS, RenderSettings
from webdgs.core.camera import Camera
from webdgs.core.scene import GaussianScene
from webdgs.ops import binning as binning_ops
from webdgs.ops import rasterize as raster_ops
from webdgs.ops.projection import (SplatAttrs, SplatAux,
                                       project_gaussians,
                                       restrict_aux_to_band)


class RenderResult(NamedTuple):
    image: jax.Array  # (H, W, 3) with background composited
    accum: jax.Array  # (H, W, 4) raw [r,g,b,accum_alpha] before background
    t_final: jax.Array  # (H, W) final transmittance (reference output_alpha)
    n_contrib: jax.Array  # (H, W) i32 last contributor per pixel
    aux: SplatAux
    binning: binning_ops.Binning


def render_from_attrs(attrs: SplatAttrs, aux: SplatAux, img_w: int,
                      img_h: int, settings: RenderSettings,
                      entry_capacity: int | None = None,
                      for_grad: bool = False):
    """Bin (non-differentiable) + rasterize (custom VJP) from projected
    splat attributes.  Differentiable w.r.t. ``attrs``.

    ``for_grad``: the gradient path has no use for the per-pixel
    n_contrib channel (only the importance replay reads it), so the
    forward skips its bookkeeping."""
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    bins = binning_ops.bin_splats(aux, img_w, img_h, settings,
                                  capacity=entry_capacity, attrs=attrs)
    attrs16 = raster_ops.pack_entry_attrs(attrs, bins.entry_gauss,
                                          bins.entry_valid)
    out = raster_ops.rasterize_tiles(attrs16, bins.tile_offsets,
                                     ntx, nty, settings,
                                     not for_grad)
    return out, bins


def pointify_attrs(attrs: SplatAttrs,
                   point_size_px: jax.Array | float,
                   settings: RenderSettings) -> SplatAttrs:
    """Substitute splat attributes so the standard compositor draws the
    reference's point-cloud debug dots (tiled-rasterizer.wgsl:212-221):
    a steep isotropic conic makes alpha cross the 1/255 threshold exactly
    at the dot radius, yielding saturated yellow discs."""
    import math

    # point_size_px may be a TRACED scalar (the viewer's ,/. keys step it
    # live; a static value would recompile the pipeline per step)
    r = jnp.maximum(jnp.asarray(point_size_px, jnp.float32), 0.5)
    if settings.max_splat_radius_px > 0:
        r = jnp.minimum(r, settings.max_splat_radius_px)
    # alpha(d) = 0.99 * exp(-0.5 k d^2) hits 1/255 at d = r
    k = 2.0 * math.log(0.99 * 255.0) / (r * r)
    n = attrs.opacity.shape[0]
    return SplatAttrs(
        center_px=attrs.center_px,
        conic=jnp.broadcast_to(jnp.stack([k, jnp.zeros_like(k), k]), (n, 3)),
        color=jnp.broadcast_to(jnp.array([1.0, 1.0, 0.0], jnp.float32),
                               (n, 3)),
        opacity=jnp.full((n,), 0.99, jnp.float32),
        # the reference tests the dot against the *gaussian* extent box
        extents=jnp.minimum(attrs.extents, r),
    )


def render_points(scene: GaussianScene, camera: Camera, img_w: int,
                  img_h: int, settings: RenderSettings = DEFAULT_SETTINGS,
                  point_size_px: jax.Array | float = 3.0,
                  gaussian_scaling: jax.Array | float | None = None
                  ) -> jax.Array:
    """Point-cloud debug mode (the reference viewer's default renderMode,
    src/viewer.ts:54, rasterized at tiled-rasterizer.wgsl:212-221: yellow
    dots of point_size_px within each splat's extent box).

    Visually equivalent to the reference (which hard-sets the pixel
    instead of blending) — see ``pointify_attrs``.
    """
    attrs, aux = project_gaussians(scene.params(), scene.alive, camera,
                                   img_w, img_h, scene.sh_deg, settings,
                                   gaussian_scaling=gaussian_scaling)
    point_attrs = pointify_attrs(attrs, point_size_px, settings)
    out, bins = render_from_attrs(point_attrs, aux, img_w, img_h, settings)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h, settings)
    return raster_ops.composite_background(tiles, settings)


def render(scene: GaussianScene, camera: Camera, img_w: int, img_h: int,
           settings: RenderSettings = DEFAULT_SETTINGS,
           entry_capacity: int | None = None,
           gaussian_scaling: jax.Array | float | None = None) -> RenderResult:
    attrs, aux = project_gaussians(scene.params(), scene.alive, camera,
                                   img_w, img_h, scene.sh_deg, settings,
                                   gaussian_scaling=gaussian_scaling)
    out, bins = render_from_attrs(attrs, aux, img_w, img_h, settings,
                                  entry_capacity)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    img_tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h,
                                          settings)
    accum = img_tiles[..., 0:4]
    t_final = img_tiles[..., raster_ops.OUT_T]
    image = raster_ops.composite_background(img_tiles, settings)
    return RenderResult(
        image=image,
        accum=accum,
        t_final=t_final,
        n_contrib=img_tiles[..., raster_ops.OUT_NCONTRIB].astype(jnp.int32),
        aux=aux,
        binning=bins,
    )


@functools.partial(jax.jit, static_argnames=(
    "img_w", "img_h", "sh_deg", "settings", "pointcloud"))
def _project_frame(params, alive, camera: Camera, img_w: int, img_h: int,
                   sh_deg: int, settings: RenderSettings,
                   gaussian_scaling: jax.Array, point_size_px: jax.Array,
                   pointcloud: bool):
    """Whole-frame projection for the banded path, run ONCE per frame (the
    bands then only restrict/shift/bin/rasterize — ADVICE r4: projection
    inside the per-band jit re-did O(N) work bands x per frame)."""
    attrs, aux = project_gaussians(params, alive, camera, img_w, img_h,
                                   sh_deg, settings,
                                   gaussian_scaling=gaussian_scaling)
    if pointcloud:
        attrs = pointify_attrs(attrs, point_size_px, settings)
    return attrs, aux


@functools.partial(jax.jit, static_argnames=(
    "img_w", "rows", "ntx", "settings", "entry_capacity"))
def _render_band(attrs: SplatAttrs, aux: SplatAux, row0: jax.Array,
                 img_w: int, rows: int, ntx: int,
                 settings: RenderSettings, entry_capacity: int | None):
    """One horizontal band of ``rows`` tile rows starting at tile row
    ``row0`` (traced — a single compile serves every band).  Returns the
    composited band image and the band's pre-drop entry demand (for the
    viewer's adaptive capacity)."""
    band_h = rows * settings.tile_h
    aux_b = restrict_aux_to_band(aux, row0, rows)
    # shift splat centers into band pixel coordinates so the kernel's
    # tile->pixel mapping stays band-local (same trick as the multi-device
    # tile-sharded renderer, parallel/sharding.py:render_tile_sharded)
    shift = (row0 * settings.tile_h).astype(jnp.float32)
    attrs_b = attrs._replace(center_px=attrs.center_px
                             - jnp.stack([jnp.zeros_like(shift), shift])[None])
    bins = binning_ops.bin_splats(aux_b, img_w, band_h, settings,
                                  capacity=entry_capacity, attrs=attrs_b)
    attrs16 = raster_ops.pack_entry_attrs(attrs_b, bins.entry_gauss,
                                          bins.entry_valid)
    out = raster_ops.rasterize_tiles(attrs16, bins.tile_offsets, ntx, rows,
                                     settings)
    tiles = raster_ops.tiles_to_image(out, ntx, rows, img_w, band_h,
                                      settings)
    return (raster_ops.composite_background(tiles, settings),
            bins.expansion_entries)


def render_banded(scene: GaussianScene, camera: Camera, img_w: int,
                  img_h: int, settings: RenderSettings = DEFAULT_SETTINGS,
                  entry_capacity: int | None = None,
                  gaussian_scaling: jax.Array | float | None = None,
                  bands: int | None = None,
                  mode: str = "gaussian",
                  point_size_px: jax.Array | float = 3.0,
                  return_entries: bool = False):
    """Single-device render of frames whose tile grid exceeds the 16-bit
    tile-key ceiling (``binning.check_tile_key_limit``): the tile rows are
    split into serial horizontal bands, each under the ceiling, rendered
    with the standard pipeline and concatenated.

    The reference shares the same 16-bit key layout and simply cannot
    render such frames (src/shaders/tiled-forward.wgsl:133-136); multi-device
    deployments use ``render_tile_sharded`` instead (one band per device).
    ``bands=None`` picks the minimum band count (1 below the ceiling, where
    this is exactly ``render(...).image``).  ``mode='pointcloud'`` renders
    the debug dots instead (the plain path's ``render_points``, which would
    raise above the ceiling).  Returns the (img_h, W, 3) composited image;
    with ``return_entries=True``, returns ``(image, max_band_entries)``
    where the second element is the largest per-band pre-drop entry demand
    (device scalar) for adaptive-capacity callers.
    """
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    if bands is None:
        rows_max = max((binning_ops.TILE_KEY_LIMIT - 1) // ntx, 1)
        bands = -(-nty // rows_max)
    gsc = jnp.float32(1.0 if gaussian_scaling is None else gaussian_scaling)
    if bands <= 1:
        if mode == "pointcloud":
            img = render_points_compiled(
                scene, camera, img_w=img_w, img_h=img_h, settings=settings,
                point_size_px=jnp.float32(point_size_px),
                gaussian_scaling=gsc)
            return (img, None) if return_entries else img
        res = render_compiled(scene, camera, img_w=img_w, img_h=img_h,
                              settings=settings,
                              entry_capacity=entry_capacity,
                              gaussian_scaling=gsc)
        if return_entries:
            return res.image, res.binning.expansion_entries
        return res.image
    rows = -(-nty // bands)
    binning_ops.check_tile_key_limit(ntx * rows)
    attrs, aux = _project_frame(scene.params(), scene.alive, camera,
                                img_w=img_w, img_h=img_h,
                                sh_deg=scene.sh_deg, settings=settings,
                                gaussian_scaling=gsc,
                                point_size_px=jnp.float32(point_size_px),
                                pointcloud=(mode == "pointcloud"))
    parts, entries = [], []
    for b in range(bands):
        img_b, ent_b = _render_band(attrs, aux, jnp.int32(b * rows),
                                    img_w=img_w, rows=rows, ntx=ntx,
                                    settings=settings,
                                    entry_capacity=entry_capacity)
        parts.append(img_b)
        entries.append(ent_b)
    image = jnp.concatenate(parts, axis=0)[:img_h]
    if return_entries:
        return image, jnp.max(jnp.stack(entries))
    return image


# Jitted entry points for EAGER callers (viewer frames, orbit export,
# bench).  ``render``/``render_points`` above are traceable building blocks
# — called bare, every one of their few hundred ops dispatches as its own
# device execution, which costs more than the render itself at interactive
# frame rates (the reference has no analogue: one command buffer per frame
# is its native shape, viewer.ts:71-100).  Jit-calling code (train step,
# evaluate, importance) keeps composing the bare functions.
render_compiled = functools.partial(
    jax.jit, static_argnames=("img_w", "img_h", "settings",
                              "entry_capacity"))(render)
# point_size_px / gaussian_scaling are TRACED: the viewer steps them live
# and a static value would pay a full pipeline recompile per key press
render_points_compiled = functools.partial(
    jax.jit, static_argnames=("img_w", "img_h", "settings"))(render_points)
