"""Image-space loss cotangent (ops/loss.py) through the tile->image layout,
against ``jax.grad`` of the surrogate loss whose gradient is the
reference's loss.wgsl formula, and the band-sharded loss against the
full frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webdgs.config import RenderSettings
from webdgs.ops import rasterize as raster_ops
from webdgs.ops.loss import (LossConfig, loss_metrics,
                                 pixel_loss_gradient, ssim_map)

SETTINGS = RenderSettings()


def _surrogate(pred, target, cfg):
    """Scalar whose gradient is loss.wgsl's per-pixel formula: the DSSIM
    factor is held constant (the reference's simplification)."""
    d = pred - target
    dssim = jax.lax.stop_gradient(
        (1.0 - ssim_map(pred, target, cfg.c1, cfg.c2)) * 0.5)
    return jnp.sum(cfg.lambda_l1 * jnp.abs(d) + 0.5 * cfg.lambda_l2 * d * d
                   + 0.5 * cfg.lambda_dssim * dssim * d * d)


def _tile_buffer(n_tiles, seed):
    rng = np.random.default_rng(seed)
    out = np.zeros((n_tiles, raster_ops.NUM_OUT, SETTINGS.tile_px),
                   np.float32)
    out[:, 0:3, :] = rng.random((n_tiles, 3, SETTINGS.tile_px)) * 0.9
    out[:, 3, :] = rng.random((n_tiles, SETTINGS.tile_px))
    out[:, raster_ops.OUT_T, :] = rng.random((n_tiles, SETTINGS.tile_px))
    return jnp.asarray(out)


def _image(out, ntx, nty, img_w, img_h):
    tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h, SETTINGS)
    return raster_ops.composite_background(tiles, SETTINGS)


@pytest.mark.parametrize("img_w,img_h", [
    (64, 64), (70, 52), (48, 48),
    (33, 20),   # 1-px-wide last tile column
    (49, 33),   # fractional tiles on both axes
])
def test_loss_gradient_matches_autodiff(img_w, img_h):
    cfg = LossConfig(lambda_l1=0.6, lambda_l2=0.2, lambda_dssim=0.2)
    ntx = -(-img_w // SETTINGS.tile_w)
    nty = -(-img_h // SETTINGS.tile_h)
    out = _tile_buffer(ntx * nty, 7)
    target = jnp.asarray(np.random.default_rng(8).random(
        (img_h, img_w, 3)).astype(np.float32))

    image, vjp = jax.vjp(lambda o: _image(o, ntx, nty, img_w, img_h), out)
    (dpix,) = vjp(pixel_loss_gradient(image, target, cfg))
    want = jax.grad(lambda o: _surrogate(_image(o, ntx, nty, img_w, img_h),
                                         target, cfg))(out)
    np.testing.assert_allclose(np.asarray(dpix), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    # pixels outside the frame crop get no cotangent
    img_full = raster_ops.tiles_to_image(dpix, ntx, nty,
                                         ntx * SETTINGS.tile_w,
                                         nty * SETTINGS.tile_h, SETTINGS)
    assert float(jnp.abs(img_full[img_h:]).sum()) == 0.0
    assert float(jnp.abs(img_full[:, img_w:]).sum()) == 0.0


def test_loss_zero_diff_zero_l1l2():
    """pred == target: l1/l2 and the whole cotangent vanish (the DSSIM
    term multiplies the difference)."""
    cfg = LossConfig()
    rng = np.random.default_rng(3)
    target = jnp.asarray(rng.random((64, 64, 3)).astype(np.float32))
    met = loss_metrics(target, target, cfg)
    assert float(met["l1"]) < 1e-6
    assert float(met["l2"]) < 1e-10
    np.testing.assert_allclose(
        np.asarray(pixel_loss_gradient(target, target, cfg)), 0.0, atol=1e-6)


def test_train_step_matches_manual_composition():
    """Full train_step vs a manually-composed image-space step: same scene
    update, same metrics."""
    from tests.test_render_forward import random_scene
    from webdgs.core.camera import default_camera
    from webdgs.ops.adam import (AdamHyperparameters, adam_step,
                                     init_adam_state)
    from webdgs.train.step import compute_param_grads, train_step

    w, h = 70, 52
    scene = random_scene(64, seed=11)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    rng = np.random.default_rng(5)
    target = jnp.asarray(rng.random((h, w, 3)).astype(np.float32))
    opt = init_adam_state(scene.params())
    cfg = LossConfig()
    hp = AdamHyperparameters()

    res = train_step(scene, opt, cam, target, img_w=w, img_h=h,
                     loss_cfg=cfg, hp=hp, settings=SETTINGS)

    image, d_params, aux, _ = compute_param_grads(
        scene, cam, target, w, h, cfg, SETTINGS, parity_sh=True)
    ref_params, _ = adam_step(scene.params(), d_params, opt, hp,
                              aux.num_tiles)
    ref_metrics = loss_metrics(image, target, cfg)

    for k in scene.params():
        np.testing.assert_allclose(
            np.asarray(res.scene.params()[k]),
            np.asarray(ref_params[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    for k in ("loss", "l1", "psnr"):
        np.testing.assert_allclose(float(res.metrics[k]),
                                   float(ref_metrics[k]), rtol=1e-5,
                                   err_msg=k)


def test_band_loss_matches_full():
    """The band-sharded loss (2-pixel halo rows from the vertical
    neighbours) reproduces the full-frame cotangent and metrics on every
    band — including a ragged bottom band and garbage halos at the frame
    borders (the clamped indexing must never read them)."""
    from webdgs.parallel.sharding import (band_loss_gradient,
                                              metrics_from_sums)

    cfg = LossConfig()
    img_w, img_h = 70, 52
    d, band_h = 4, 16  # 64 padded rows: the last band is 4 rows real
    rng = np.random.default_rng(17)
    pred = rng.random((d * band_h, img_w, 3)).astype(np.float32)
    target = jnp.asarray(rng.random((img_h, img_w, 3)).astype(np.float32))
    garbage = jnp.asarray(rng.random((2, img_w, 3)) * 5.0, jnp.float32)

    full = np.asarray(pixel_loss_gradient(jnp.asarray(pred[:img_h]), target,
                                          cfg))
    want = loss_metrics(jnp.asarray(pred[:img_h]), target, cfg)
    grads, parts = [], []
    for b in range(d):
        band = jnp.asarray(pred[b * band_h:(b + 1) * band_h])
        above = (jnp.asarray(pred[b * band_h - 2:b * band_h]) if b > 0
                 else garbage)
        below = (jnp.asarray(pred[(b + 1) * band_h:(b + 1) * band_h + 2])
                 if b < d - 1 else garbage)
        g, p = band_loss_gradient(band, above, below, target, b * band_h,
                                  img_h, cfg)
        grads.append(np.asarray(g))
        parts.append(np.asarray(p))
    got = np.concatenate(grads, axis=0)
    np.testing.assert_allclose(got[:img_h], full, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[img_h:], 0.0)
    met = metrics_from_sums(jnp.asarray(np.sum(parts, axis=0)),
                            float(img_h * img_w * 3), cfg)
    for k in ("l1", "l2", "dssim", "loss", "psnr"):
        np.testing.assert_allclose(float(met[k]), float(want[k]),
                                   rtol=1e-5, err_msg=k)
