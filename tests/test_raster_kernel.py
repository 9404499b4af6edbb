"""The Pallas-Triton rasterizer kernels (interpret mode on the CPU) and
their plain-lax twin against the dense autodiff compositor
(tests/dense_raster.py), on hand-built tile layouts that hit the kernels'
edge cases: ranges that start mid-chunk, empty tiles, saturation early
exit, and two tiles whose ranges share one chunk of the entry buffer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webdgs.config import RenderSettings
from webdgs.ops import rasterize as R

from tests.dense_raster import rasterize_dense

SETTINGS = RenderSettings(tile_w=16, tile_h=16, chunk=16)
NTX, NTY = 2, 2

# per-tile entry counts for each layout (chunk = 16)
LAYOUTS = {
    # tile 1's range [37, 70) starts mid-chunk; chunk [32, 48) is shared
    # by tiles 0 and 1
    "unaligned_shared_chunk": ([37, 33, 5, 20], 0.8),
    "empty_tiles": ([0, 41, 0, 7], 0.8),
    # opaque splats saturate every pixel within the first chunks: the loop
    # must stop early and the skipped slots must read zero gradient
    "saturation": ([90, 3, 64, 17], 0.99),
    "single_entry": ([1, 1, 0, 1], 0.9),
}


def _layout(counts, opacity, seed=0):
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n = int(offs[-1])
    e_cap = n + 2 * SETTINGS.chunk + 3  # padding past the last tile
    tile = np.repeat(np.arange(len(counts)), counts)
    tw, th = SETTINGS.tile_w, SETTINGS.tile_h
    a = np.zeros((R.NUM_ROWS, e_cap), np.float32)
    a[R.ROW_CX, :n] = (tile % NTX) * tw + rng.uniform(-6, tw + 6, n)
    a[R.ROW_CY, :n] = (tile // NTX) * th + rng.uniform(-6, th + 6, n)
    if opacity >= 0.99:  # large opaque splats: saturate fast
        a[R.ROW_CA, :n] = rng.uniform(0.002, 0.01, n)
        a[R.ROW_CC, :n] = rng.uniform(0.002, 0.01, n)
        a[R.ROW_OP, :n] = rng.uniform(0.9, 3.0, n)  # clamps at alpha_max
    else:
        a[R.ROW_CA, :n] = rng.uniform(0.02, 0.3, n)
        a[R.ROW_CC, :n] = rng.uniform(0.02, 0.3, n)
        a[R.ROW_OP, :n] = rng.uniform(0.05, opacity, n)
    a[R.ROW_CB, :n] = rng.uniform(-0.01, 0.01, n)
    a[R.ROW_R:R.ROW_B + 1, :n] = rng.uniform(0, 1, (3, n))
    a[R.ROW_EX:R.ROW_EY + 1, :n] = rng.uniform(4, 30, (2, n))
    return jnp.asarray(a), offs


def _cotangent(seed=1):
    rng = np.random.default_rng(seed)
    ct = rng.normal(size=(NTX * NTY, R.NUM_OUT, SETTINGS.tile_px))
    ct[:, R.OUT_NCONTRIB] = 0.0
    return jnp.asarray(ct.astype(np.float32))


def _grad(fn, attrs, offs, ct):
    _, vjp = jax.vjp(lambda a: fn(a), attrs)
    return np.asarray(vjp(ct)[0])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_forward_matches_dense(layout):
    attrs, offs = _layout(*LAYOUTS[layout])
    out = np.asarray(R.rasterize_tiles(attrs, jnp.asarray(offs), NTX, NTY,
                                       SETTINGS))
    ref = np.asarray(rasterize_dense(attrs, offs, NTX, NTY, SETTINGS))
    np.testing.assert_allclose(out[:, :R.OUT_NCONTRIB],
                               ref[:, :R.OUT_NCONTRIB], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(out[:, R.OUT_NCONTRIB],
                                  ref[:, R.OUT_NCONTRIB])
    if layout == "saturation":
        assert (out[:, R.OUT_T] < SETTINGS.t_threshold).mean() > 0.5


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_gradients_match_dense(layout):
    attrs, offs = _layout(*LAYOUTS[layout])
    ct = _cotangent()
    got = _grad(lambda a: R.rasterize_tiles(a, jnp.asarray(offs), NTX, NTY,
                                            SETTINGS, False), attrs, offs, ct)
    want = _grad(lambda a: rasterize_dense(a, offs, NTX, NTY, SETTINGS),
                 attrs, offs, ct)
    n = int(offs[-1])
    scale = np.abs(want[:, :n]).max()
    np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=1e-4,
                               atol=1e-5 * max(scale, 1.0))


def test_saturated_slots_get_zero_gradient():
    """Entries behind a saturated tile are never composited: the backward
    kernel's early exit must still store exact zeros into their slots."""
    attrs, offs = _layout(*LAYOUTS["saturation"])
    ct = _cotangent()
    out = np.asarray(R.rasterize_tiles(attrs, jnp.asarray(offs), NTX, NTY,
                                       SETTINGS))
    got = _grad(lambda a: R.rasterize_tiles(a, jnp.asarray(offs), NTX, NTY,
                                            SETTINGS, False), attrs, offs, ct)
    # tile 0 (90 entries) saturates early: its last chunk is past n_contrib
    last = int(out[0, R.OUT_NCONTRIB].max())
    tail = slice(-(-last // SETTINGS.chunk) * SETTINGS.chunk, int(offs[1]))
    assert tail.start < tail.stop, "layout no longer saturates tile 0"
    np.testing.assert_array_equal(got[:, tail], 0.0)


def test_kernel_matches_plain_twin():
    """Kernel and plain twin run the same chunk maths: forward and
    backward agree to rounding on every layout at once."""
    for counts, op in LAYOUTS.values():
        attrs, offs = _layout(counts, op, seed=3)
        o = jnp.asarray(offs)
        ct = _cotangent(4)
        np.testing.assert_allclose(
            np.asarray(R.rasterize_tiles(attrs, o, NTX, NTY, SETTINGS)),
            np.asarray(R.rasterize_tiles_plain(attrs, o, NTX, NTY,
                                               SETTINGS)),
            rtol=1e-6, atol=1e-6)
        n = int(offs[-1])
        gk = _grad(lambda a: R.rasterize_tiles(a, o, NTX, NTY, SETTINGS,
                                               False), attrs, offs, ct)
        gp = _grad(lambda a: R.rasterize_tiles_plain(a, o, NTX, NTY,
                                                     SETTINGS, False),
                   attrs, offs, ct)
        np.testing.assert_allclose(gk[:, :n], gp[:, :n], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.gpu
def test_kernels_on_gpu(gpu):
    """On the card: the compiled kernels against the plain twin at a
    realistic frame (the same comparison chip_smoke.py makes at full
    size)."""
    from webdgs.core.camera import default_camera
    from webdgs.ops import binning as B
    from webdgs.ops.projection import project_gaussians
    from tests.test_render_forward import random_scene

    w, h = 256, 192
    s = RenderSettings()
    scene = random_scene(5000, seed=2)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w, h,
                                   scene.sh_deg, s)
    bins = B.bin_splats(aux, w, h, s, attrs=attrs)
    a16 = R.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid)
    ntx, nty = B.tile_grid(w, h, s)
    ct = jnp.asarray(np.random.default_rng(0).normal(
        size=(ntx * nty, R.NUM_OUT, s.tile_px)).astype(np.float32))
    ct = ct.at[:, R.OUT_NCONTRIB].set(0.0)
    valid = np.asarray(bins.entry_valid)
    outs, grads = [], []
    with jax.default_matmul_precision("highest"):
        for fn in (R.rasterize_tiles, R.rasterize_tiles_plain):
            out, vjp = jax.vjp(lambda a: fn(a, bins.tile_offsets, ntx, nty,
                                            s, False), a16)
            outs.append(np.asarray(out))
            grads.append(np.asarray(vjp(ct)[0])[:, valid])
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4)
    rel = np.linalg.norm(grads[0] - grads[1]) / np.linalg.norm(grads[1])
    assert rel < 1e-3, rel
