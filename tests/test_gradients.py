"""Gradient verification (BASELINE config 2).

1. The hand-written rasterizer backward vs JAX autodiff of the dense
   differentiable reference compositor — must agree to float tolerance,
   including the acc_alpha / T_final cotangent paths and threshold masks.
2. End-to-end finite-difference gradcheck through projection + binning +
   rasterization on all five parameter groups (means, quats, log_scales,
   opacity_logits, sh) — the verification the reference never had
   (SURVEY.md section 4: its hand-derived WGSL gradients were only ever
   validated by training convergence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webdgs.config import RenderSettings
from webdgs.core.camera import default_camera
from webdgs.ops import binning as binning_ops
from webdgs.ops import rasterize as raster_ops
from webdgs.ops.projection import project_gaussians
from webdgs.render.renderer import render

from tests.dense_raster import rasterize_dense
from tests.test_render_forward import random_scene

SETTINGS = RenderSettings(chunk=128)
EXACT = SETTINGS


def _setup(n=80, w=48, h=32, seed=3, opacity_boost=0.0):
    scene = random_scene(n, seed=seed)
    if opacity_boost:
        scene = scene.replace(
            opacity_logits=scene.opacity_logits + opacity_boost)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w, h,
                                   scene.sh_deg, SETTINGS)
    bins = binning_ops.bin_splats(aux, w, h, SETTINGS)
    ntx, nty = binning_ops.tile_grid(w, h, SETTINGS)
    attrs16 = raster_ops.pack_entry_attrs(attrs, bins.entry_gauss,
                                          bins.entry_valid)
    return scene, cam, attrs16, bins, ntx, nty


@pytest.mark.slow
@pytest.mark.parametrize("opacity_boost", [0.0, 5.0])
def test_backward_kernel_matches_dense_autodiff(opacity_boost):
    # opacity_boost=5 drives alphas into the 0.99 clamp and the pixels into
    # saturation, exercising both non-smooth masks
    _, _, attrs16, bins, ntx, nty = _setup(opacity_boost=opacity_boost)
    offs = np.asarray(bins.tile_offsets)

    out_kernel = raster_ops.rasterize_tiles(attrs16, bins.tile_offsets,
                                            ntx, nty, EXACT)
    out_dense = rasterize_dense(attrs16, offs, ntx, nty, EXACT)
    np.testing.assert_allclose(np.asarray(out_kernel),
                               np.asarray(out_dense), rtol=3e-4, atol=3e-4)

    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, out_kernel.shape).astype(np.float32)
    # n_contrib and spare channels are non-differentiable outputs
    g[:, raster_ops.OUT_NCONTRIB:, :] = rng.normal(
        0, 1, g[:, raster_ops.OUT_NCONTRIB:, :].shape)
    g = jnp.asarray(g)

    _, vjp_k = jax.vjp(
        lambda a: raster_ops.rasterize_tiles(a, bins.tile_offsets, ntx, nty,
                                             EXACT), attrs16)
    _, vjp_d = jax.vjp(lambda a: rasterize_dense(a, offs, ntx, nty,
                                                 EXACT), attrs16)
    (dk,) = vjp_k(g)
    (dd,) = vjp_d(g)
    dk = np.asarray(dk)[:11]  # rows 11..15 are padding
    dd = np.asarray(dd)[:11]
    scale = np.maximum(np.abs(dd).max(), 1.0)
    np.testing.assert_allclose(dk / scale, dd / scale, rtol=1e-3, atol=1e-4)


@pytest.mark.slow
def test_end_to_end_finite_differences():
    n, w, h = 40, 32, 32
    scene = random_scene(n, seed=11, sh_deg=2)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    rng = np.random.default_rng(5)
    wgt = jnp.asarray(rng.normal(0, 1, (h, w, 3)).astype(np.float32))

    def loss(params):
        s = scene.with_params(params)
        res = render(s, cam, w, h, SETTINGS)
        return jnp.sum(res.image * wgt)

    params = scene.params()
    val, grads = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(val))

    # The loss surface has non-smooth boundaries (SnugBox extent tests,
    # 16-bit depth bins, saturation threshold) so individual central
    # differences carry noise; check the population statistically.
    eps = 2e-3
    rel_errs = []
    for key, n_checks in [("means", 8), ("quats", 6), ("log_scales", 6),
                          ("opacity_logits", 6), ("sh", 6)]:
        arr = np.asarray(params[key])
        flat = arr.reshape(-1)
        g_flat = np.asarray(grads[key]).reshape(-1)
        # probe the coordinates with the largest analytic gradient plus a
        # few random ones (zero-gradient coords verify culling masks)
        order = np.argsort(-np.abs(g_flat))
        idxs = list(order[:n_checks // 2]) + list(
            rng.integers(0, flat.size, n_checks - n_checks // 2))
        for i in idxs:
            fp = flat.copy()
            fp[i] += eps
            fm = flat.copy()
            fm[i] -= eps
            lp = float(loss({**params,
                             key: jnp.asarray(fp.reshape(arr.shape))}))
            lm = float(loss({**params,
                             key: jnp.asarray(fm.reshape(arr.shape))}))
            fd = (lp - lm) / (2 * eps)
            an = float(g_flat[i])
            rel = abs(fd - an) / (max(abs(fd), abs(an)) + 1e-2)
            rel_errs.append((f"{key}[{i}]", fd, an, rel))

    rels = np.array([r[-1] for r in rel_errs])
    worst = max(rel_errs, key=lambda r: r[-1])
    assert len(rels) >= 30
    assert np.median(rels) < 0.025, f"median rel err {np.median(rels):.4f}"
    assert np.mean(rels < 0.10) >= 0.85, f"too many outliers; worst {worst}"
    assert rels.max() < 0.5, f"gross mismatch: {worst}"


@pytest.mark.slow
@pytest.mark.slow
def test_finite_differences_smoothed_settings():
    """Tight-tolerance FD gradcheck on a *smoothed* configuration: low
    opacities (no alpha clamp, no saturation early-exit), alpha_min=0 (no
    contribution threshold).  The remaining non-smoothness (extent-box
    edges, depth-order ties) is negligible at these opacities, so the VJP
    must agree with central differences at the 1e-3 class — 10-25x tighter
    than the general-position check above, catching subtler VJP bugs."""
    n, w, h = 30, 32, 32
    smooth = RenderSettings(chunk=128, alpha_min=0.0)
    scene = random_scene(n, seed=17, sh_deg=1)
    # sigmoid(-1.5) ~ 0.18: far from the 0.99 clamp and saturation
    scene = scene.replace(
        opacity_logits=jnp.full_like(scene.opacity_logits, -1.5))
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    rng = np.random.default_rng(19)
    wgt = jnp.asarray(rng.normal(0, 1, (h, w, 3)).astype(np.float32))

    def loss(params):
        s = scene.with_params(params)
        res = render(s, cam, w, h, smooth)
        return jnp.sum(res.image * wgt)

    params = scene.params()
    val, grads = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(val))

    def central_diff(key, arr, flat, i, eps):
        fp = flat.copy(); fp[i] += eps
        fm = flat.copy(); fm[i] -= eps
        lp = float(loss({**params,
                         key: jnp.asarray(fp.reshape(arr.shape))}))
        lm = float(loss({**params,
                         key: jnp.asarray(fm.reshape(arr.shape))}))
        return (lp - lm) / (2 * eps)

    rels = []
    for key, n_checks in [("means", 6), ("quats", 5), ("log_scales", 5),
                          ("opacity_logits", 5), ("sh", 5)]:
        arr = np.asarray(params[key])
        flat = arr.reshape(-1)
        g_flat = np.asarray(grads[key]).reshape(-1)
        # largest-gradient coordinates: maximal FD signal-to-noise in f32
        for i in np.argsort(-np.abs(g_flat))[:n_checks]:
            an = float(g_flat[i])
            # a coordinate whose FD interval straddles one of the rare
            # discontinuities (an extent-box edge or a 16-bit depth-order
            # flip) shows a large-eps jump that VANISHES as eps shrinks —
            # a true VJP bug persists at every eps (verified by an eps
            # sweep: quats[51] converges 17.2 -> 3.274 vs analytic 3.278)
            rel = np.inf
            for eps in (1e-3, 2.5e-4, 1e-4):
                fd = central_diff(key, arr, flat, i, eps)
                rel = min(rel,
                          abs(fd - an) / (max(abs(fd), abs(an)) + 1e-3))
                if rel < 2e-2:
                    break
            rels.append(rel)
    rels = np.array(rels)
    assert len(rels) >= 25
    assert np.median(rels) < 5e-3, f"median rel err {np.median(rels):.5f}"
    assert np.mean(rels < 2e-2) >= 0.9, f"outliers: {np.sort(rels)[-4:]}"
    assert rels.max() < 0.1, f"gross mismatch {rels.max():.4f}"
