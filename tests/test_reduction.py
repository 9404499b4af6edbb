"""Per-Gaussian gradient accumulation: the transpose of the entry gather in
``pack_entry_attrs`` (an XLA scatter-add).  The reference accumulates the
same sums via 1e-6 fixed-point atomics (src/shaders/common.wgsl:110-121);
here they must equal a numpy group-by of the valid entry cotangents."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webdgs.ops import rasterize as raster_ops
from webdgs.ops.projection import SplatAttrs


def _attrs(n, rng):
    return SplatAttrs(
        center_px=jnp.asarray(rng.normal(size=(n, 2)), jnp.float32),
        conic=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        color=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        opacity=jnp.asarray(rng.normal(size=(n,)), jnp.float32),
        extents=jnp.asarray(rng.normal(size=(n, 2)), jnp.float32))


def _entries(n, e_cap, rng):
    """Depth-sorted-like layout: a random permutation of Gaussian-grouped
    entries (counts per Gaussian in [0, 8]), valid prefix, padding after
    (padding repeats the last id, as the binning emits)."""
    counts = rng.integers(0, 9, n)
    while counts.sum() > e_cap:
        counts[rng.integers(0, n)] = 0
    total = int(counts.sum())
    ids = rng.permutation(np.repeat(np.arange(n), counts)).astype(np.int32)
    pad = np.full(e_cap - total, ids[-1] if total else 0, np.int32)
    return np.concatenate([ids, pad]), np.arange(e_cap) < total


def _groupby(ct, ids, valid, n):
    out = np.zeros((n, ct.shape[0]), np.float64)
    np.add.at(out, ids[valid], ct[:, valid].T.astype(np.float64))
    return out


def _per_gauss_grad(attrs, ids, valid, ct):
    _, vjp = jax.vjp(lambda a: raster_ops.pack_entry_attrs(
        a, jnp.asarray(ids), jnp.asarray(valid)), attrs)
    (d,) = vjp(jnp.asarray(ct))
    return np.asarray(raster_ops._pack_per_gauss(d))


@pytest.mark.parametrize("n,e_cap,seed", [
    (100, 512, 0),
    (700, 2048, 1),     # several entries per Gaussian, ragged counts
    (37, 256, 2),       # padding-heavy
    (1201, 4096, 3),
])
def test_gather_transpose_matches_groupby(n, e_cap, seed):
    rng = np.random.default_rng(seed)
    ids, valid = _entries(n, e_cap, rng)
    ct = (rng.standard_normal((raster_ops.NUM_ROWS, e_cap)) * 8).astype(
        np.float32)
    got = _per_gauss_grad(_attrs(n, rng), ids, valid, ct)
    np.testing.assert_allclose(got, _groupby(ct, ids, valid, n),
                               rtol=1e-5, atol=1e-4)
    assert got.shape == (n, raster_ops.NUM_ROWS)


def test_invalid_slots_do_not_leak():
    """The backward kernel leaves slots outside every tile unwritten, so
    the cotangent may hold any bits there: NaN and huge values in invalid
    slots must not reach any Gaussian (Gaussian 0 least of all, which the
    padding ids point at)."""
    rng = np.random.default_rng(5)
    n, e_cap = 50, 512
    ids, valid = _entries(n, e_cap, rng)
    ct = rng.standard_normal((raster_ops.NUM_ROWS, e_cap)).astype(np.float32)
    ct[:, ~valid] = np.nan
    ct[0, ~valid] = 1e38
    got = _per_gauss_grad(_attrs(n, rng), ids, valid, ct)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _groupby(ct, ids, valid, n), rtol=1e-5,
                               atol=1e-4)


def test_pack_zeroes_invalid_entries():
    """Forward side of the same contract: padding slots are all-zero rows
    (opacity 0 makes them exact no-ops in the compositor)."""
    rng = np.random.default_rng(6)
    n, e_cap = 40, 256
    ids, valid = _entries(n, e_cap, rng)
    attrs = _attrs(n, rng)
    packed = np.asarray(raster_ops.pack_entry_attrs(
        attrs, jnp.asarray(ids), jnp.asarray(valid)))
    assert packed.shape == (raster_ops.NUM_ROWS, e_cap)
    np.testing.assert_array_equal(packed[:, ~valid], 0.0)
    per_g = np.asarray(raster_ops._pack_per_gauss(attrs))
    np.testing.assert_array_equal(packed[:, valid], per_g[ids[valid]].T)
