"""End-to-end forward render vs the sequential NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webdgs.config import RenderSettings
from webdgs.core.camera import default_camera
from webdgs.core.scene import scene_from_arrays
from webdgs.ops import binning as binning_ops
from webdgs.ops.projection import project_gaussians
from webdgs.render.renderer import render

from tests.reference_raster import render_reference


def random_scene(n, seed=0, spread=1.0, sh_deg=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, spread, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    log_scales = rng.uniform(-3.5, -1.5, (n, 3)).astype(np.float32)
    opacity = rng.uniform(-1.0, 3.0, (n,)).astype(np.float32)
    sh = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    sh[:, 0, :] += 0.8
    return scene_from_arrays(means, quats, log_scales, opacity, sh,
                             sh_deg=sh_deg)


@pytest.mark.parametrize("n,size,sh_deg", [
    (60, (64, 48), 0),
    pytest.param(200, (80, 64), 3, marks=pytest.mark.slow),
])
def test_forward_matches_reference(n, size, sh_deg):
    w, h = size
    settings = RenderSettings(chunk=128)
    scene = random_scene(n, seed=42, sh_deg=sh_deg)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))

    res = jax.jit(
        lambda s: render(s, cam, w, h, settings),
    )(scene)

    attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w, h,
                                   scene.sh_deg, settings)
    # attrs: the oracle replays the SAME (tile-culled) entry layout the
    # production render used — n_contrib is a position within that layout
    # (cull-on/off image equivalence is pinned in test_binning)
    bins = binning_ops.bin_splats(aux, w, h, settings, attrs=attrs)
    ntx, nty = binning_ops.tile_grid(w, h, settings)
    np_attrs = {k: np.asarray(v) for k, v in attrs._asdict().items()}
    ref_img, ref_t, ref_nc = render_reference(
        np_attrs, np.asarray(bins.entry_gauss),
        np.asarray(bins.entry_valid), np.asarray(bins.tile_offsets),
        ntx, nty, w, h,
        settings.tile_w, settings.tile_h)

    assert int(jnp.sum(aux.visible)) > 0, "test scene should be visible"
    # tolerances sized for cross-platform float noise (GPU transcendentals
    # round differently from the CPU interpreter)
    np.testing.assert_allclose(np.asarray(res.image), ref_img,
                               rtol=1e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(res.t_final), ref_t,
                               rtol=3e-4, atol=3e-4)
    nc = np.asarray(res.n_contrib)
    mismatch = np.mean(nc != ref_nc)
    assert mismatch <= 0.005, f"n_contrib mismatch rate {mismatch:.4f}"


def test_empty_scene_renders_background():
    settings = RenderSettings(chunk=128, background=(0.2, 0.3, 0.4))
    scene = random_scene(8)
    scene = scene.replace(alive=jnp.zeros_like(scene.alive))
    cam = default_camera(32, 32, position=(0.0, 0.0, -5.0))
    res = render(scene, cam, 32, 32, settings)
    np.testing.assert_allclose(
        np.asarray(res.image),
        np.broadcast_to(np.array([0.2, 0.3, 0.4], np.float32), (32, 32, 3)),
        atol=1e-6)
    assert np.all(np.asarray(res.t_final) == 1.0)


def test_saturation_early_termination():
    # stack many opaque splats at the same spot; n_contrib must stop growing
    n = 64
    rng = np.random.default_rng(1)
    means = rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    scene = scene_from_arrays(
        means,
        opacity_logits=np.full((n,), 6.0, np.float32),  # sigmoid ~ 0.9975
        log_scales=np.full((n, 3), -1.0, np.float32),
        colors=np.full((n, 3), 0.9, np.float32))
    settings = RenderSettings(chunk=128)
    cam = default_camera(32, 32, position=(0.0, 0.0, -5.0))
    res = render(scene, cam, 32, 32, settings)
    nc = np.asarray(res.n_contrib)
    center_nc = nc[16, 16]
    assert 0 < center_nc < n, "early termination should cut the list short"
    assert np.asarray(res.t_final)[16, 16] < 0.01


def test_entry_budget_overflow_drops_whole_gaussians():
    """With a tiny entry capacity, later Gaussians are dropped whole and the
    render still matches the oracle restricted to the kept set."""
    w, h = 48, 32
    settings = RenderSettings(chunk=128)
    scene = random_scene(50, seed=51)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))

    attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w, h,
                                   scene.sh_deg, settings)
    cap = 128  # one chunk: far fewer than the scene emits
    bins = binning_ops.bin_splats(aux, w, h, settings, capacity=cap)
    assert int(bins.total_entries) <= cap

    # emulate the same whole-gaussian drop for the oracle
    counts = np.asarray(aux.num_tiles)
    keep = np.cumsum(counts) <= cap
    aux_kept = aux._replace(
        visible=jnp.asarray(np.asarray(aux.visible) & keep),
        num_tiles=jnp.asarray(np.where(keep, counts, 0).astype(np.int32)))
    bins_kept = binning_ops.bin_splats(aux_kept, w, h, settings)
    ntx, nty = binning_ops.tile_grid(w, h, settings)

    from webdgs.ops import rasterize as raster_ops
    a16 = raster_ops.pack_entry_attrs(attrs, bins.entry_gauss,
                                      bins.entry_valid)
    out = raster_ops.rasterize_tiles(a16, bins.tile_offsets, ntx, nty,
                                     settings)
    a16_k = raster_ops.pack_entry_attrs(attrs, bins_kept.entry_gauss,
                                        bins_kept.entry_valid)
    out_k = raster_ops.rasterize_tiles(a16_k, bins_kept.tile_offsets, ntx,
                                       nty, settings)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_k),
                               rtol=1e-5, atol=1e-6)


def test_sh_eval_matches_reference_formula():
    """eval_sh_color vs an independent transcription of the reference's
    nested-degree evaluation (tiled-forward.wgsl:89-119)."""
    from webdgs.ops.sh import eval_sh_color

    C0 = 0.28209479177387814
    C1 = 0.4886025119029199
    C2 = [1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396]
    C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435]

    rng = np.random.default_rng(77)
    n = 32
    sh = rng.normal(0, 0.5, (n, 16, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    for deg in range(4):
        got = np.asarray(eval_sh_color(jnp.asarray(sh), jnp.asarray(dirs),
                                       deg))
        expect = np.zeros((n, 3))
        for i in range(n):
            x, y, z = dirs[i]
            c = C0 * sh[i, 0]
            if deg > 0:
                c = c - C1 * y * sh[i, 1] + C1 * z * sh[i, 2] \
                    - C1 * x * sh[i, 3]
            if deg > 1:
                xx, yy, zz = x * x, y * y, z * z
                xy, yz, xz = x * y, y * z, x * z
                c = (c + C2[0] * xy * sh[i, 4] + C2[1] * yz * sh[i, 5]
                     + C2[2] * (2 * zz - xx - yy) * sh[i, 6]
                     + C2[3] * xz * sh[i, 7] + C2[4] * (xx - yy) * sh[i, 8])
            if deg > 2:
                c = (c + C3[0] * y * (3 * xx - yy) * sh[i, 9]
                     + C3[1] * xy * z * sh[i, 10]
                     + C3[2] * y * (4 * zz - xx - yy) * sh[i, 11]
                     + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[i, 12]
                     + C3[4] * x * (4 * zz - xx - yy) * sh[i, 13]
                     + C3[5] * z * (xx - yy) * sh[i, 14]
                     + C3[6] * x * (xx - 3 * yy) * sh[i, 15])
            expect[i] = np.maximum(c + 0.5, 0.0)
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6,
                                   err_msg=f"deg {deg}")


def test_sh_rows_matches_einsum_oracle():
    """The projection hot path's row-form SH (planar (48, N) coefficients,
    fused (N,) FMAs) vs the dense-einsum oracle, all degrees."""
    from webdgs.ops.sh import eval_sh_color, eval_sh_color_rows

    rng = np.random.default_rng(78)
    n = 64
    sh = rng.normal(0, 0.5, (n, 16, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    planar = jnp.asarray(sh.reshape(n, 48).T)
    dx, dy, dz = (jnp.asarray(dirs[:, i]) for i in range(3))
    for deg in range(4):
        want = np.asarray(eval_sh_color(jnp.asarray(sh), jnp.asarray(dirs),
                                        deg))
        r0, r1, r2 = eval_sh_color_rows(planar, dx, dy, dz, deg)
        got = np.stack([np.asarray(r0), np.asarray(r1), np.asarray(r2)], -1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"deg {deg}")
