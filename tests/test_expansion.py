"""Ragged per-Gaussian expansion (ops/binning.py): the id repeat and the
per-entry sort keys, checked against numpy repeat / a direct key
recomputation."""

import numpy as np
import pytest

import jax.numpy as jnp

from webdgs.config import DEFAULT_SETTINGS
from webdgs.ops.binning import _repeat_ids, expand_entries


@pytest.mark.parametrize("n,e_cap,seed", [
    (100, 512, 0),
    (700, 2048, 1),
    (1300, 4096, 2),     # ragged
    (40, 512, 3),        # mostly padding
])
def test_repeat_ids_matches_numpy(n, e_cap, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.int32)
    counts[rng.random(n) < 0.2] = 0  # zero-count runs
    while counts.sum() > e_cap:
        counts[rng.integers(0, n)] = 0
    total = int(counts.sum())
    ids = np.asarray(_repeat_ids(jnp.asarray(counts), e_cap))
    ref = np.repeat(np.arange(n, dtype=np.int32), counts)
    np.testing.assert_array_equal(ids[:total], ref)
    # padding slots repeat the last emitted id (callers mask them)
    np.testing.assert_array_equal(ids[total:], ref[-1] if total else 0)


def _depth16(depth):
    bits = np.asarray(depth, np.float32).view(np.uint32)
    ordered = np.where(bits >> 31 != 0, ~bits, bits | np.uint32(0x80000000))
    return np.minimum(ordered >> 16, 0xFFFE).astype(np.uint32)


@pytest.mark.parametrize("cull", [False, True])
def test_expand_entries_keys_match_numpy(cull):
    """Every valid slot's key is (tile << 16) | depth16 of a tile in its
    Gaussian's rect, in Gaussian-grouped order; without the cull the keys
    enumerate each rect row-major, with it they are the rect's survivors
    (a subset, in the same order); invalid slots hold the sentinel."""
    import dataclasses

    from webdgs.core.camera import default_camera
    from webdgs.ops.projection import project_gaussians

    from tests.test_render_forward import random_scene

    scene = random_scene(300, seed=5)
    w = h = 96
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    s = dataclasses.replace(DEFAULT_SETTINGS, tile_cull=cull)
    attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w, h,
                                   scene.sh_deg, s)
    ntx = -(-w // s.tile_w)
    e_cap = 2048
    key, g, counts, total, keep, demand = expand_entries(
        aux, ntx, e_cap, attrs=attrs, settings=s)
    key, g, counts = np.asarray(key), np.asarray(g), np.asarray(counts)
    total = int(total)
    assert total == counts.sum() > 0
    np.testing.assert_array_equal(key[total:], np.uint32(0xFFFFFFFF))

    tmin = np.asarray(aux.tile_min)
    tdim = np.asarray(aux.tile_dims)
    d16 = _depth16(aux.depth)
    off = np.cumsum(counts) - counts
    for gi in np.flatnonzero(counts):
        rect = [((tmin[gi, 1] + q) * ntx + tmin[gi, 0] + r) << 16
                | int(d16[gi])
                for q in range(tdim[gi, 1]) for r in range(tdim[gi, 0])]
        got = key[off[gi]:off[gi] + counts[gi]].astype(np.int64).tolist()
        np.testing.assert_array_equal(g[off[gi]:off[gi] + counts[gi]], gi)
        if cull:
            it = iter(rect)
            assert all(k in it for k in got), f"gaussian {gi}"
        else:
            assert got == rect, f"gaussian {gi}"
    assert int(demand) >= total
