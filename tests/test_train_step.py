"""Adam semantics, loss gradients, and a training-convergence smoke test
(a miniature of BASELINE config 3)."""

import jax
import jax.numpy as jnp
import numpy as np

from webdgs.config import RenderSettings
from webdgs.core.camera import default_camera
from webdgs.ops.adam import (AdamHyperparameters, adam_step,
                                 init_adam_state, unpack_rows)
from webdgs.ops.loss import LossConfig, pixel_loss_gradient, ssim_map
from webdgs.render.renderer import render
from webdgs.train.step import train_step

from tests.test_render_forward import random_scene

SETTINGS = RenderSettings(chunk=128)


def test_adam_reference_semantics():
    rng = np.random.default_rng(0)
    n = 16
    params = {
        "means": jnp.asarray(rng.normal(0, 1, (n, 3)).astype(np.float32)),
        "quats": jnp.asarray(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        "log_scales": jnp.asarray(rng.normal(0, 1, (n, 3)).astype(np.float32)),
        "opacity_logits": jnp.asarray(rng.normal(0, 1, (n,)).astype(np.float32)),
        "sh": jnp.asarray(rng.normal(0, 1, (n, 16, 3)).astype(np.float32)),
    }
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(0, 1, p.shape).astype(np.float32)),
        params)
    hp = AdamHyperparameters()
    state = init_adam_state(params)
    tile_counts = jnp.asarray((rng.random(n) > 0.4).astype(np.int32))

    new_params, new_state = adam_step(params, grads, state, hp, tile_counts)

    vis = np.asarray(tile_counts) > 0
    # frozen where invisible (params AND moments)
    for k in params:
        np.testing.assert_array_equal(
            np.asarray(new_params[k])[~vis], np.asarray(params[k])[~vis])
        np.testing.assert_array_equal(
            np.asarray(unpack_rows(new_state.m)[k])[~vis], 0.0)

    # no bias correction: first visible step is -lr * g' / (sqrt(g'^2 * (1-b2)) ...)
    g = np.asarray(grads["means"])[vis]
    p = np.asarray(params["means"])[vis]
    m = (1 - hp.beta1) * g
    v = (1 - hp.beta2) * g * g
    expect = p - hp.lr_pos * m / (np.sqrt(v) + hp.epsilon)
    np.testing.assert_allclose(np.asarray(new_params["means"])[vis], expect,
                               rtol=1e-5, atol=1e-6)

    # quaternions renormalized after update
    qn = np.linalg.norm(np.asarray(new_params["quats"])[vis], axis=-1)
    np.testing.assert_allclose(qn, 1.0, atol=1e-5)

    # parity SH: only DC moves
    sh_new = np.asarray(new_params["sh"])[vis]
    sh_old = np.asarray(params["sh"])[vis]
    assert not np.allclose(sh_new[:, 0, :], sh_old[:, 0, :])
    np.testing.assert_array_equal(sh_new[:, 1:, :], sh_old[:, 1:, :])


def test_loss_gradient_semantics():
    rng = np.random.default_rng(1)
    pred = jnp.asarray(rng.random((24, 20, 3)).astype(np.float32))
    targ = jnp.asarray(rng.random((24, 20, 3)).astype(np.float32))

    # identical images: ssim == 1, gradient == 0
    s = np.asarray(ssim_map(pred, pred))
    np.testing.assert_allclose(s, 1.0, atol=1e-4)
    g0 = np.asarray(pixel_loss_gradient(pred, pred, LossConfig()))
    np.testing.assert_allclose(g0, 0.0, atol=1e-6)

    # pure L1: sign of the difference, scaled
    cfg = LossConfig(lambda_l1=0.7, lambda_l2=0.0, lambda_dssim=0.0)
    g = np.asarray(pixel_loss_gradient(pred, targ, cfg))
    np.testing.assert_allclose(g, 0.7 * np.sign(np.asarray(pred - targ)),
                               atol=1e-7)

    # L2 term
    cfg = LossConfig(lambda_l1=0.0, lambda_l2=1.0, lambda_dssim=0.0)
    g = np.asarray(pixel_loss_gradient(pred, targ, cfg))
    np.testing.assert_allclose(g, np.asarray(pred - targ), atol=1e-7)


def test_training_converges_smoke():
    w, h = 32, 32
    gt_scene = random_scene(12, seed=7)
    gt_scene = gt_scene.replace(
        opacity_logits=gt_scene.opacity_logits + 2.0)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    target = render(gt_scene, cam, w, h, SETTINGS).image
    target = jax.lax.stop_gradient(target)

    # init: perturbed copy of ground truth
    rng = np.random.default_rng(8)
    scene = gt_scene.replace(
        means=gt_scene.means + jnp.asarray(
            rng.normal(0, 0.1, gt_scene.means.shape).astype(np.float32)),
        sh=gt_scene.sh + jnp.asarray(
            rng.normal(0, 0.15, gt_scene.sh.shape).astype(np.float32)),
    )
    opt = init_adam_state(scene.params())
    # boosted lrs so 40 steps show clear movement on this toy problem
    hp = AdamHyperparameters(lr_pos=0.01, lr_color=0.05, lr_opacity=0.05,
                             lr_scale=0.01, lr_rot=0.01)
    cfg = LossConfig()

    losses = []
    for i in range(40):
        scene, opt, metrics = train_step(
            scene, opt, cam, target, img_w=w, img_h=h, loss_cfg=cfg, hp=hp,
            settings=SETTINGS)
        losses.append(float(metrics["loss"]))

    assert np.isfinite(losses).all()
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < 0.6 * first, f"loss did not converge: {first} -> {last}"


def test_position_lr_decay_option():
    rng = np.random.default_rng(2)
    n = 4
    params = {
        "means": jnp.asarray(rng.normal(0, 1, (n, 3)).astype(np.float32)),
        "quats": jnp.asarray(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        "log_scales": jnp.zeros((n, 3), jnp.float32),
        "opacity_logits": jnp.zeros((n,), jnp.float32),
        "sh": jnp.zeros((n, 16, 3), jnp.float32),
    }
    grads = jax.tree.map(lambda p: jnp.ones_like(p), params)
    counts = jnp.ones((n,), jnp.int32)
    hp = AdamHyperparameters(lr_pos_final=1.6e-6, lr_pos_decay_steps=100)
    state = init_adam_state(params)
    # at late iterations the position step shrinks toward lr_pos_final
    state_late = state.replace(iteration=jnp.int32(99))
    p_early, _ = adam_step(params, grads, state, hp, counts)
    p_late, _ = adam_step(params, grads, state_late, hp, counts)
    d_early = np.abs(np.asarray(p_early["means"] - params["means"])).mean()
    d_late = np.abs(np.asarray(p_late["means"] - params["means"])).mean()
    assert d_late < d_early * 0.05
    # other groups unaffected by the schedule
    np.testing.assert_allclose(np.asarray(p_early["log_scales"]),
                               np.asarray(p_late["log_scales"]))


def test_gaussian_ssim_metric():
    from webdgs.ops.loss import ssim
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.random((40, 32, 3)).astype(np.float32))
    assert abs(float(ssim(a, a)) - 1.0) < 1e-4
    b = jnp.asarray(rng.random((40, 32, 3)).astype(np.float32))
    v = float(ssim(a, b))
    assert -0.2 < v < 0.5  # unrelated noise: low similarity
    # slightly noisy copy: high but < 1
    c = a + jnp.asarray(rng.normal(0, 0.02, a.shape).astype(np.float32))
    vc = float(ssim(a, c))
    assert 0.8 < vc < 1.0


def test_quantize_budget_ladder():
    """Adaptive budgets move in coarse geometric rungs: a steadily-growing
    observation (a densifying scene) must reuse compiled shapes, not
    retrigger a recompile per chunk of growth; overshoot stays bounded."""
    from webdgs.train.trainer import quantize_budget

    chunk = 128
    # chunk multiple, floor respected
    assert quantize_budget(1, chunk, chunk * 8) == chunk * 8
    prev = None
    distinct = set()
    # sweep a 16x growth in 2% steps: few distinct shapes, bounded overshoot
    want = 50_000.0
    while want < 800_000:
        q = quantize_budget(want, chunk, chunk * 8)
        assert q % chunk == 0
        assert q >= want                # never undersized
        assert q <= want * 1.35         # rung overshoot bounded
        if prev is not None:
            assert q >= prev            # monotone in this sweep
        distinct.add(q)
        prev = q
        want *= 1.02
    # 4 octaves of growth -> a handful of compiles, not hundreds of steps
    assert len(distinct) <= 40, len(distinct)
