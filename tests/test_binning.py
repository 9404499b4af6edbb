"""Randomized invariants of the binning stage (ops/binning.py).

The forward-oracle tests pin binning indirectly (an exact-match render
implies correct ranges for those scenes); this fuzz suite checks the index
arithmetic DIRECTLY across random configurations, including the edge cases
oracles rarely hit: capacity overflow (whole-Gaussian drop, the reference's
maxTileEntries budget, tiled-forward-pass.ts:137-158), tiles touching the
frame border, and degenerate single-tile rects.
"""

import numpy as np
import pytest

from webdgs.config import RenderSettings
from webdgs.core.camera import default_camera
from webdgs.ops.binning import bin_splats, tile_grid
from webdgs.ops.projection import project_gaussians

from tests.test_render_forward import random_scene


def _project(n, seed, w, h, settings):
    scene = random_scene(n, seed=seed)
    scene = scene.replace(opacity_logits=scene.opacity_logits + 2.0)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    return project_gaussians(scene.params(), scene.alive, cam, w, h,
                             scene.sh_deg, settings)


@pytest.mark.parametrize("seed,n,w,h,capacity", [
    (0, 60, 64, 48, None),
    (1, 60, 96, 48, None),
    (2, 200, 80, 80, None),
    (3, 200, 48, 64, 512),   # tight capacity: whole-Gaussian drops
    (4, 8, 64, 64, None),   # near-empty
])
def test_binning_invariants(seed, n, w, h, capacity):
    settings = RenderSettings(chunk=128)
    attrs, aux = _project(n, seed, w, h, settings)
    ntx, nty = tile_grid(w, h, settings)
    bins = bin_splats(aux, w, h, settings, capacity=capacity)

    num_tiles = np.asarray(aux.num_tiles)
    tile_min = np.asarray(aux.tile_min)
    tile_dims = np.asarray(aux.tile_dims)
    depth16 = np.minimum(
        (np.frombuffer(np.asarray(aux.depth).tobytes(), np.uint32)
         ^ np.uint32(0x80000000)) >> 16, 0xFFFE).astype(np.int64)

    e_cap = bins.capacity
    # whole-Gaussian drop at the budget: kept prefix by cumulative count
    keep = np.cumsum(num_tiles) <= e_cap
    kept_counts = np.where(keep, num_tiles, 0)
    total = int(kept_counts.sum())

    assert int(bins.total_entries) == total
    tile_counts = np.asarray(bins.tile_counts)
    assert int(tile_counts.sum()) == total
    valid = np.asarray(bins.entry_valid)
    assert int(valid.sum()) == total
    # sorted layout: exactly the first `total` slots are valid
    np.testing.assert_array_equal(valid, np.arange(e_cap) < total)

    # unaligned ranges: offsets are the plain cumsum of per-tile counts
    offs = np.asarray(bins.tile_offsets)
    np.testing.assert_array_equal(offs[1:] - offs[:-1], tile_counts)

    # per-slot: the slot's tile (from the ranges) must be covered
    # by its gaussian's tile rect, and per-tile counts must match exactly
    gauss = np.asarray(bins.entry_gauss)
    slot_tile = np.searchsorted(offs[1:], np.arange(offs[-1]), side="right")
    per_tile = np.zeros(ntx * nty, np.int64)
    for k in np.flatnonzero(valid):
        t, g = slot_tile[k], gauss[k]
        ty, tx = divmod(t, ntx)
        assert keep[g]
        assert tile_min[g, 0] <= tx < tile_min[g, 0] + tile_dims[g, 0]
        assert tile_min[g, 1] <= ty < tile_min[g, 1] + tile_dims[g, 1]
        per_tile[t] += 1
    np.testing.assert_array_equal(per_tile, tile_counts)

    # within a tile, valid entries are depth-sorted (16-bit keys; ties
    # arbitrary, SURVEY Q5)
    for t in np.flatnonzero(tile_counts):
        rows = gauss[offs[t]:offs[t] + tile_counts[t]]
        d = depth16[rows]
        assert (np.diff(d) >= 0).all(), f"tile {t} not depth-ordered"

    # the sorted key's tile field names the same tile as the ranges
    entry_tile = np.asarray(bins.entry_tile)
    np.testing.assert_array_equal(entry_tile[:total], slot_tile)


@pytest.mark.parametrize("seed,n,w,h", [(0, 300, 96, 64), (1, 120, 64, 64)])
def test_tile_cull_image_identical(seed, n, w, h):
    """The exact per-(gaussian, tile) alpha cull (settings.tile_cull) must
    not change the rendered image or its gradients: culled pairs have
    alpha < alpha_min at every pixel of their tile, which the rasterizer's
    mask already zeroes (reference parity: the SnugBox rect binning,
    tiled-forward.wgsl:298-354, merely over-covers)."""
    import jax
    import jax.numpy as jnp

    from webdgs.ops import rasterize as raster_ops
    from webdgs.render.renderer import render_from_attrs

    settings_on = RenderSettings(chunk=128, tile_cull=True)
    settings_off = RenderSettings(chunk=128, tile_cull=False)
    attrs, aux = _project(n, seed, w, h, settings_on)
    ntx, nty = tile_grid(w, h, settings_on)

    def run(settings):
        def f(a):
            out, bins = render_from_attrs(a, aux, w, h, settings,
                                          for_grad=True)
            img = raster_ops.composite_background(
                raster_ops.tiles_to_image(out, ntx, nty, w, h, settings),
                settings)
            return jnp.sum(jnp.sin(img * 3.0)), (img, bins)
        (loss, (img, bins)), grads = jax.value_and_grad(f, has_aux=True)(
            attrs)
        return img, grads, bins

    img_on, g_on, bins_on = run(settings_on)
    img_off, g_off, bins_off = run(settings_off)

    # something must actually be culled for this test to mean anything
    assert int(bins_on.total_entries) < int(bins_off.total_entries)
    np.testing.assert_allclose(np.asarray(img_on), np.asarray(img_off),
                               atol=1e-6, rtol=1e-5)
    # gradients: culling shifts entries across chunk boundaries, changing
    # f32/bf16 accumulation order — f16-class noise relative to the leaf's
    # own scale, same budget as the bf16x3 error tests
    for a, b in zip(jax.tree.leaves(g_on), jax.tree.leaves(g_off)):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(np.asarray(a), b, rtol=2e-3,
                                   atol=2e-4 * scale)

    # the searchsorted tile ranges agree with a direct histogram of the
    # surviving entries
    offs = np.asarray(bins_on.tile_offsets)
    gauss = np.asarray(bins_on.entry_gauss)
    total = int(bins_on.total_entries)
    counts = np.asarray(bins_on.tile_counts)
    assert offs[-1] == total
    np.testing.assert_array_equal(np.diff(offs), counts)
    assert counts.sum() == total


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tile_cull_image_identical_near_threshold(seed):
    """Property sweep of the cull's conservatism margins (ADVICE r3): the
    image-identical guarantee rests on empirical slack (qthr*(1+1e-5)+1e-4,
    qmin*(1-2^-12), 1e-3 px extent slack) against the kernel's
    independently-rounded f32 alpha, not on derived error bounds.  Drive
    opacities densely THROUGH the alpha_min boundary — max splat alpha in
    [0.3x, 3x] alpha_min — where a margin failure would cull a pair the
    kernel keeps at one boundary pixel, and require bitwise-identical
    images."""
    import jax.numpy as jnp
    import math

    from webdgs.ops import rasterize as raster_ops
    from webdgs.render.renderer import render_from_attrs

    n, w, h = 400, 96, 64
    settings_on = RenderSettings(chunk=128, tile_cull=True)
    settings_off = RenderSettings(chunk=128, tile_cull=False)
    scene = random_scene(n, seed=seed)
    # peak alpha = sigmoid(logit): put it log-uniformly in
    # [0.3, 3] * alpha_min so many pairs straddle the cull threshold
    rng = np.random.default_rng(100 + seed)
    peak = (1.0 / 255.0) * np.exp(rng.uniform(math.log(0.3), math.log(3.0),
                                              n))
    logits = np.log(peak / (1.0 - peak)).astype(np.float32)
    scene = scene.replace(opacity_logits=jnp.asarray(logits))
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w, h,
                                   scene.sh_deg, settings_on)
    ntx, nty = tile_grid(w, h, settings_on)

    def run(settings):
        out, bins = render_from_attrs(attrs, aux, w, h, settings)
        img = raster_ops.composite_background(
            raster_ops.tiles_to_image(out, ntx, nty, w, h, settings),
            settings)
        return np.asarray(img), bins

    img_on, bins_on = run(settings_on)
    img_off, bins_off = run(settings_off)
    # near-threshold scenes cull heavily; require real coverage
    assert int(bins_on.total_entries) < int(bins_off.total_entries)
    np.testing.assert_array_equal(img_on, img_off)
