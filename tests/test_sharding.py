"""Multi-device execution on the 8-way virtual CPU mesh: tile-sharded
rendering must match single-device rendering; data-parallel training must
match a single-device step over the same batch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webdgs.config import RenderSettings
from webdgs.core.camera import default_camera
from webdgs.ops.adam import AdamHyperparameters, init_adam_state
from webdgs.ops.loss import LossConfig
from webdgs.parallel.sharding import (dp_train_step, make_mesh,
                                          render_tile_sharded)
from webdgs.render.renderer import render
from webdgs.train.step import compute_param_grads
from webdgs.ops.adam import adam_step

from tests.test_render_forward import random_scene

SETTINGS = RenderSettings(chunk=128)
# exact f32 entry exchange: the tight-equivalence tests verify the
# exchange algebra bit-or-f32-close; the f16 default is covered by the
# *_f16_class tests at the reference's attribute precision
SETTINGS_EXACT = dataclasses.replace(SETTINGS, exchange_f16=False)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    return make_mesh()


@pytest.mark.slow
def test_tile_sharded_render_matches_single(mesh):
    w, h = 64, 64
    scene = random_scene(80, seed=21)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    single = np.asarray(render(scene, cam, w, h, SETTINGS).image)
    sharded = np.asarray(render_tile_sharded(scene, cam, w, h, mesh,
                                             SETTINGS))
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_dp_train_step_matches_single(mesh):
    w, h = 32, 32
    d = len(mesh.devices.reshape(-1))
    scene = random_scene(30, seed=22)
    gt = random_scene(30, seed=23)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)

    cams = []
    targets = []
    for i in range(d):
        cam = default_camera(w, h, position=(0.1 * i, 0.0, -5.0))
        cams.append(cam)
        targets.append(render(gt, cam, w, h, SETTINGS).image)
    cam_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    target_batch = jnp.stack(targets)

    hp = AdamHyperparameters()
    cfg = LossConfig()
    opt = init_adam_state(scene.params())

    new_scene, new_opt, metrics = dp_train_step(
        scene, opt, cam_batch, target_batch, mesh, img_w=w, img_h=h,
        loss_cfg=cfg, hp=hp, settings=SETTINGS)
    # DP returns the same metrics surface as the single-device step
    for key in ("loss", "l1", "l2", "dssim", "psnr", "visible",
                "tile_entries"):
        assert key in metrics, key
    loss = metrics["loss"]

    # single-device equivalent: accumulate grads over the same batch
    params = scene.params()
    grads = jax.tree.map(jnp.zeros_like, params)
    counts = jnp.zeros((scene.capacity,), jnp.int32)
    for i in range(d):
        _, g, aux, _ = compute_param_grads(
            scene, cams[i], targets[i], w, h, cfg, SETTINGS,
            parity_sh=True)
        grads = jax.tree.map(jnp.add, grads, g)
        counts = counts + aux.num_tiles
    grads = jax.tree.map(lambda x: x / d, grads)
    ref_params, _ = adam_step(params, grads, opt, hp, counts)

    for k in ref_params:
        np.testing.assert_allclose(
            np.asarray(new_scene.params()[k]), np.asarray(ref_params[k]),
            rtol=2e-4, atol=2e-6, err_msg=k)
    assert np.isfinite(float(loss))


@pytest.mark.slow
def test_trainer_with_mesh(mesh):
    import numpy as np
    from webdgs.core.camera import CameraData, default_camera
    from webdgs.render.renderer import render
    from webdgs.train.config import (DensifyPruneConfig, DensifySchedule,
                                         TrainerConfig)
    from webdgs.train.trainer import Trainer
    from tests.test_render_forward import random_scene

    w = h = 32
    gt = random_scene(12, seed=50)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    fy = 0.5 * h / np.tan(np.radians(45.0) / 2)
    cams, imgs = [], []
    for i in range(4):
        pos = (0.2 * i, 0.0, -5.0)
        cam = default_camera(w, h, position=pos)
        img = np.asarray(render(gt, cam, w, h, SETTINGS).image)
        cams.append(CameraData(id=i, position=np.asarray(pos, np.float32),
                               rotation=np.eye(3, dtype=np.float32),
                               fx=fy, fy=fy, width=w, height=h,
                               img_name=f"v{i}.png"))
        imgs.append({"name": f"v{i}.png", "image": img, "width": w,
                     "height": h})
    cfg = TrainerConfig(
        densify=DensifyPruneConfig(schedule=DensifySchedule(enabled=False)))
    trainer = Trainer(random_scene(8, seed=51), cams, imgs, cfg, SETTINGS,
                      initial_capacity=16, mesh=mesh)
    losses = [float(trainer.step()["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses))
    # the DP path feeds the same metrics surface as single-device: psnr for
    # the log line, tile_entries for the adaptive entry capacity
    assert np.isfinite(float(trainer.last_metrics["psnr"]))
    assert trainer._entry_cap_peak > 0  # adapted from DP metrics


@pytest.mark.slow
def test_trainer_with_mesh_densify(mesh):
    """A densify event must work while training on a mesh: the jitted event
    runs on replicated state and the swap survives the next DP step."""
    from webdgs.core.camera import CameraData, default_camera
    from webdgs.render.renderer import render
    from webdgs.train.config import (DensifyPruneConfig, DensifySchedule,
                                         TrainerConfig)
    from webdgs.train.trainer import Trainer
    from tests.test_render_forward import random_scene

    w = h = 32
    gt = random_scene(12, seed=60)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    fy = 0.5 * h / np.tan(np.radians(45.0) / 2)
    cams, imgs = [], []
    for i in range(4):
        pos = (0.2 * i, 0.0, -5.0)
        cam = default_camera(w, h, position=pos)
        img = np.asarray(render(gt, cam, w, h, SETTINGS).image)
        cams.append(CameraData(id=i, position=np.asarray(pos, np.float32),
                               rotation=np.eye(3, dtype=np.float32),
                               fx=fy, fy=fy, width=w, height=h,
                               img_name=f"v{i}.png"))
        imgs.append({"name": f"v{i}.png", "image": img, "width": w,
                     "height": h})
    cfg = TrainerConfig(densify=DensifyPruneConfig(
        schedule=DensifySchedule(enabled=True, warmup_iterations=2,
                                 interval=2, stop_iterations=10),
        metric_views=2, clone_threshold_count=1, prune_opacity=0.005))
    trainer = Trainer(random_scene(8, seed=61), cams, imgs, cfg, SETTINGS,
                      initial_capacity=64, mesh=mesh)
    for _ in range(5):  # crosses the warmup boundary -> >=1 densify event
        m = trainer.step()
        assert np.isfinite(float(m["loss"]))
    assert trainer.last_densify_iteration is not None
    assert np.isfinite(float(trainer.step()["loss"]))  # post-swap DP step


@pytest.mark.slow
def test_tile_sharded_more_devices_than_rows(mesh):
    # H=32 -> 2 tile rows, 8 devices: most bands are empty padding
    w, h = 48, 32
    scene = random_scene(40, seed=24)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    single = np.asarray(render(scene, cam, w, h, SETTINGS).image)
    sharded = np.asarray(render_tile_sharded(scene, cam, w, h, mesh,
                                             SETTINGS))
    assert sharded.shape == (h, w, 3)
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_gaussian_sharded_render_matches_single(mesh):
    """Entry all-to-all render: gaussian-axis sharding + band exchange must
    match the single-device frame (O(E/D) per-chip entry memory)."""
    from webdgs.parallel.sharding import render_gaussian_sharded

    w, h = 64, 64
    scene = random_scene(80, seed=25)
    d = len(mesh.devices.reshape(-1))
    cap = -(-scene.capacity // d) * d
    scene = scene.pad_to(cap)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    single = np.asarray(render(scene, cam, w, h, SETTINGS).image)
    sharded, dropped = render_gaussian_sharded(scene, cam, w, h, mesh,
                                               SETTINGS_EXACT)
    assert int(dropped) == 0
    np.testing.assert_allclose(np.asarray(sharded), single, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.slow
def test_gaussian_sharded_render_drop_budget(mesh):
    """With a tiny send budget a concentrated scene overflows: the render
    degrades (reference maxTileEntries semantics) and reports the drops."""
    from webdgs.parallel.sharding import render_gaussian_sharded

    w, h = 64, 64
    # 16x16 tiles: the overflow engineering below is tuned to per-band
    # entry counts at this tiling (wider default tiles halve entries per
    # gaussian and the one-chunk budget stops overflowing)
    settings16 = dataclasses.replace(SETTINGS, tile_w=16, tile_h=16)
    scene = random_scene(400, seed=26)
    # concentrate everything: large splats all over one band
    scene = scene.replace(log_scales=scene.log_scales + 1.5)
    d = len(mesh.devices.reshape(-1))
    scene = scene.pad_to(-(-scene.capacity // d) * d)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    img, dropped = render_gaussian_sharded(scene, cam, w, h, mesh,
                                           settings16,
                                           send_capacity=settings16.chunk)
    assert img.shape == (h, w, 3)
    assert np.isfinite(np.asarray(img)).all()
    assert int(dropped) > 0


@pytest.mark.slow
def test_gs_train_step_matches_single(mesh):
    """Fully-sharded training (scene + optimizer sharded over the gaussian
    axis, entries all_to_all'd forward, cotangents back through the
    transpose) must produce the same update as the single-device step."""
    from webdgs.parallel.sharding import gs_train_step
    from webdgs.train.step import train_step

    w, h = 64, 64
    d = len(mesh.devices.reshape(-1))
    scene = random_scene(64, seed=27)
    scene = scene.pad_to(-(-scene.capacity // d) * d)
    gt = random_scene(30, seed=28)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    target = render(gt, cam, w, h, SETTINGS).image

    hp = AdamHyperparameters()
    cfg = LossConfig()
    opt = init_adam_state(scene.params())

    ref_scene, ref_opt, ref_m = train_step(
        scene, opt, cam, target, img_w=w, img_h=h, loss_cfg=cfg, hp=hp,
        settings=SETTINGS_EXACT)
    new_scene, new_opt, m = gs_train_step(
        scene, opt, cam, target, mesh, img_w=w, img_h=h, loss_cfg=cfg,
        hp=hp, settings=SETTINGS_EXACT)

    assert int(m["entries_dropped"]) == 0
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-4)
    assert int(m["visible"]) == int(ref_m["visible"])
    assert int(m["tile_entries"]) == int(ref_m["tile_entries"])
    for k in ref_scene.params():
        np.testing.assert_allclose(
            np.asarray(new_scene.params()[k]),
            np.asarray(ref_scene.params()[k]),
            rtol=2e-4, atol=2e-6, err_msg=k)
    # optimizer moments are sharded but concatenate to the single-device
    # state in order.  Tolerance: the two paths accumulate per-Gaussian
    # gradients with different f32 algorithms (prefix-segment reduction vs
    # the exchange-transpose scatter-add), so moments — raw gradient scale —
    # differ by accumulation-order noise up to ~0.5% relative on small
    # entries; the Adam update itself (params above) normalizes this away
    # to 2e-4, which is the equivalence that matters.
    np.testing.assert_allclose(np.asarray(new_opt.m),
                               np.asarray(ref_opt.m),
                               rtol=1e-2, atol=1e-6)


@pytest.mark.slow
def test_gs_train_step_2d_mesh(mesh):
    """dp x band 2D mesh: each dp row trains its own view band-sharded;
    a gradient psum over dp averages the batch.  Must match single-device
    gradient accumulation over the same two views."""
    from jax.sharding import Mesh
    from webdgs.parallel.sharding import gs_train_step

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh2 = Mesh(devs, ("dp", "band"))
    w, h = 64, 64
    scene = random_scene(64, seed=29)
    scene = scene.pad_to(-(-scene.capacity // 4) * 4)
    gt = random_scene(30, seed=28)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    cams = [default_camera(w, h, position=(0.15 * i, 0.0, -5.0))
            for i in range(2)]
    targets = jnp.stack([render(gt, c, w, h, SETTINGS).image for c in cams])
    cam_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)

    hp = AdamHyperparameters()
    cfg = LossConfig()
    opt = init_adam_state(scene.params())

    new_scene, new_opt, m = gs_train_step(
        scene, opt, cam_batch, targets, mesh2, img_w=w, img_h=h,
        loss_cfg=cfg, hp=hp, settings=SETTINGS_EXACT)
    assert int(m["entries_dropped"]) == 0

    # single-device reference: average grads over the two views, OR the
    # visibility counts
    params = scene.params()
    grads = jax.tree.map(jnp.zeros_like, params)
    counts = jnp.zeros((scene.capacity,), jnp.int32)
    for i in range(2):
        _, g, aux, _ = compute_param_grads(
            scene, cams[i], targets[i], w, h, cfg, SETTINGS_EXACT,
            parity_sh=True)
        grads = jax.tree.map(jnp.add, grads, g)
        counts = counts + aux.num_tiles
    grads = jax.tree.map(lambda x: x / 2, grads)
    ref_params, _ = adam_step(params, grads, opt, hp, counts)

    for k in ref_params:
        np.testing.assert_allclose(
            np.asarray(new_scene.params()[k]), np.asarray(ref_params[k]),
            rtol=2e-4, atol=2e-6, err_msg=k)
    assert np.isfinite(float(m["loss"]))


def _canonical_rows(scene, opt=None):
    """Alive rows of a scene (params + optionally moments), sorted by a
    lexicographic key over the means — placement-invariant comparison
    between the single-device and sharded densify events."""
    alive = np.asarray(scene.alive)
    feats = [np.asarray(scene.means)[alive],
             np.asarray(scene.quats)[alive],
             np.asarray(scene.log_scales)[alive],
             np.asarray(scene.opacity_logits)[alive][:, None],
             np.asarray(scene.sh)[alive].reshape(alive.sum(), -1)]
    if opt is not None:
        feats.append(np.asarray(opt.m)[alive])
        feats.append(np.asarray(opt.v)[alive])
    mat = np.concatenate(feats, axis=1)
    order = np.lexsort(mat.T[::-1])
    return mat[order]


@pytest.mark.slow
def test_gs_densify_event_matches_single(mesh):
    """The sharded densify event must produce the exact output SET of the
    single-device event (same sources, actions, transforms, RNG rows);
    only slot placement may differ."""
    from webdgs.ops.densify import densify_prune
    from webdgs.ops.importance import multiview_importance_counts
    from webdgs.parallel.gs_trainer import (gs_densify_event,
                                                rebalance_shards)
    from webdgs.train.config import DensifyPruneConfig

    w, h = 64, 64
    mw, mh = 32, 32
    d = len(mesh.devices.reshape(-1))
    scene = random_scene(64, seed=70)
    scene = scene.replace(opacity_logits=scene.opacity_logits + 1.0)
    # headroom + balanced shards, the state the GsTrainer maintains (it
    # rebalances before every event); both events run on the SAME state so
    # the cap-order comparison is exact
    scene = scene.pad_to(128)
    opt = init_adam_state(scene.params())
    # non-trivial moments so the move/reset rules are exercised
    opt = opt.replace(m=opt.m + 0.25, v=opt.v + 0.5)
    scene, opt = rebalance_shards(scene, opt, d)
    # the rebalance itself spreads alive rows evenly
    alive_per_shard = np.asarray(scene.alive).reshape(d, -1).sum(axis=1)
    assert alive_per_shard.max() - alive_per_shard.min() <= 1

    gt = random_scene(30, seed=71)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    cams = [default_camera(mw, mh, position=(0.2 * i, 0.0, -5.0))
            for i in range(3)]
    cam_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    targets = jnp.stack(
        [render(gt, c, w, h, SETTINGS).image for c in
         [default_camera(w, h, position=(0.2 * i, 0.0, -5.0))
          for i in range(3)]])
    view_idx = jnp.asarray([0, 1, 2], jnp.int32)
    key = jax.random.PRNGKey(7)

    cfg = DensifyPruneConfig(metric_views=3, clone_threshold_count=2,
                             prune_opacity=0.01, split_scale_threshold=0.2,
                             max_new_points_per_step=20)

    # single-device: counts then event (the Trainer's composition)
    t_small = jax.image.resize(targets, (3, mh, mw, 3), "linear")
    counts = multiview_importance_counts(
        scene.params(), scene.alive, scene.sh_deg, cam_batch, t_small,
        mw, mh, cfg.metric_threshold, SETTINGS)
    ref = densify_prune(scene, opt, counts, cfg, key)

    got = gs_densify_event(scene, opt, cam_batch, targets, view_idx, key,
                           mesh, mw=mw, mh=mh, cfg=cfg, settings=SETTINGS)

    assert int(got.out_total) == int(ref.out_total)
    assert int(got.in_alive) == int(ref.in_alive)
    assert int(got.n_cloned) == int(ref.n_cloned)
    assert int(got.n_split) == int(ref.n_split)
    assert int(got.n_pruned) == int(ref.n_pruned)
    # at least one clone/split/prune actually happened, else vacuous
    assert (int(ref.n_cloned) + int(ref.n_split) + int(ref.n_pruned)) > 0

    ref_rows = _canonical_rows(ref.scene, ref.opt_state)
    got_rows = _canonical_rows(got.scene, got.opt_state)
    np.testing.assert_array_equal(got_rows, ref_rows)


@pytest.mark.slow
def test_gs_trainer_loop_matches_single(mesh):
    """VERDICT item 3 done-criterion: a full GsTrainer loop with >=1
    densify event matches the single-device Trainer loop (same seeds, same
    view draws) within the gs tolerance."""
    from webdgs.core.camera import CameraData
    from webdgs.parallel.gs_trainer import GsTrainer
    from webdgs.train.config import (DensifyPruneConfig,
                                         DensifySchedule, TrainerConfig)
    from webdgs.train.trainer import Trainer

    w = h = 32
    gt = random_scene(12, seed=80)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    fy = 0.5 * h / np.tan(np.radians(45.0) / 2)
    cams, imgs = [], []
    for i in range(4):
        pos = (0.2 * i, 0.0, -5.0)
        cam = default_camera(w, h, position=pos)
        img = np.asarray(render(gt, cam, w, h, SETTINGS).image)
        cams.append(CameraData(id=i, position=np.asarray(pos, np.float32),
                               rotation=np.eye(3, dtype=np.float32),
                               fx=fy, fy=fy, width=w, height=h,
                               img_name=f"v{i}.png"))
        imgs.append({"name": f"v{i}.png", "image": img, "width": w,
                     "height": h})
    cfg = TrainerConfig(densify=DensifyPruneConfig(
        schedule=DensifySchedule(enabled=True, warmup_iterations=3,
                                 interval=3, stop_iterations=10),
        metric_views=2, clone_threshold_count=1, prune_opacity=0.005,
        max_new_points_per_step=8))
    cams_r = [default_camera(w, h, position=(0.2 * i, 0.0, -5.0))
              for i in range(4)]

    t_ref = Trainer(random_scene(8, seed=81), cams, imgs, cfg,
                    SETTINGS_EXACT, initial_capacity=64)
    t_gs = GsTrainer(random_scene(8, seed=81), cams, imgs, cfg,
                     SETTINGS_EXACT, mesh=mesh, initial_capacity=64)

    for _ in range(5):  # crosses the warmup boundary -> >=1 densify event
        m_ref = t_ref.step()
        m_gs = t_gs.step()
        np.testing.assert_allclose(float(m_gs["loss"]),
                                   float(m_ref["loss"]), rtol=5e-3)
    assert t_gs.last_densify_iteration is not None
    assert t_gs.last_densify_iteration == t_ref.last_densify_iteration
    assert t_gs.num_points == t_ref.num_points
    # adaptation kicked in from the gs metrics
    assert t_gs._gs_entry_cap is not None
    assert t_gs._gs_send_cap is not None
    # Post-event states agree set-wise within the gs-loop tolerance.  The
    # sharded path accumulates each gaussian's gradient in a different f32
    # order than the single-device global sort (psum/scatter-add vs
    # sequential segments), and Adam's scale invariance turns ulp-level
    # differences into near-full-step drift for parameters whose net
    # gradient nearly cancels; over 5 steps + a densify event a small tail
    # of elements drifts visibly.  Bound: structure identical (asserted
    # above), the vast majority of elements tight, and the two final
    # scenes render the same frame.
    ref_rows = _canonical_rows(t_ref.scene)
    got_rows = _canonical_rows(t_gs.scene)
    assert ref_rows.shape == got_rows.shape
    err = np.abs(got_rows - ref_rows)
    tight = err <= 2e-2 * np.abs(ref_rows) + 2e-4
    assert np.mean(tight) > 0.95, np.mean(tight)
    f_ref = np.asarray(render(t_ref.scene, cams_r[0], w, h,
                              SETTINGS_EXACT).image)
    f_gs = np.asarray(render(t_gs.scene, cams_r[0], w, h,
                             SETTINGS_EXACT).image)
    assert np.abs(f_gs - f_ref).max() < 1e-1, np.abs(f_gs - f_ref).max()
    assert np.abs(f_gs - f_ref).mean() < 2e-3, np.abs(f_gs - f_ref).mean()


@pytest.mark.slow
def test_gs_adaptive_send_capacity(mesh):
    """VERDICT item 5 done-criterion: a concentrated scene that initially
    drops entries converges to zero drops within a few adaptation
    intervals, without manual budgets."""
    from webdgs.core.camera import CameraData
    from webdgs.parallel.gs_trainer import GsTrainer
    from webdgs.train.config import (DensifyPruneConfig,
                                         DensifySchedule, TrainerConfig)

    w, h = 128, 64
    # concentrated: every splat is large and centered, so entries pile into
    # the middle tile bands and the per-(device, band) send peak exceeds
    # the one-chunk budget below (measured: send_max ~200 at step 1 at
    # 16x16 tiles — the tiling this engineering is tuned to)
    settings16 = dataclasses.replace(SETTINGS, tile_w=16, tile_h=16)
    scene = random_scene(256, seed=90)
    scene = scene.replace(
        means=scene.means * 0.3,
        log_scales=jnp.full_like(scene.log_scales, -0.2),
        opacity_logits=scene.opacity_logits + 2.0)
    fy = 0.5 * h / np.tan(np.radians(45.0) / 2)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    img = np.asarray(render(scene, cam, w, h, SETTINGS).image)
    cams = [CameraData(id=0,
                       position=np.asarray((0.0, 0.0, -5.0), np.float32),
                       rotation=np.eye(3, dtype=np.float32),
                       fx=fy, fy=fy, width=w, height=h, img_name="v0.png")]
    imgs = [{"name": "v0.png", "image": img, "width": w, "height": h}]
    cfg = TrainerConfig(densify=DensifyPruneConfig(
        schedule=DensifySchedule(enabled=False)))
    tr = GsTrainer(random_scene(256, seed=90).replace(
        means=scene.means, log_scales=scene.log_scales,
        opacity_logits=scene.opacity_logits), cams, imgs, cfg, settings16,
        mesh=mesh, initial_capacity=256)
    tr.ENTRY_CAP_INTERVAL = 2
    tr._gs_send_cap = settings16.chunk  # deliberately too small
    # a roomy expansion capacity so the send budget is the binding limit
    # (the heuristic e_loc would floor at one chunk for 32 splats/device,
    # making overload structurally impossible)
    tr._gs_entry_cap = 1024

    dropped = []
    for _ in range(8):
        m = tr.step()
        dropped.append(int(m["entries_dropped"]))
    assert dropped[0] > 0, f"test not exercising drops: {dropped}"
    assert dropped[-1] == 0, f"budget never adapted: {dropped}"
    assert tr._gs_send_cap > SETTINGS.chunk


@pytest.mark.slow
def test_gs_trainer_2d_mesh_loop(mesh):
    """GsTrainer on a 2D dp x band mesh: a short loop crossing a densify
    boundary runs end to end — per-step view batches over dp, scene/Adam
    band-sharded, sharded densify event on the band axis."""
    from jax.sharding import Mesh
    from webdgs.core.camera import CameraData
    from webdgs.parallel.gs_trainer import GsTrainer
    from webdgs.train.config import (DensifyPruneConfig,
                                         DensifySchedule, TrainerConfig)

    w = h = 32
    gt = random_scene(12, seed=84)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    fy = 0.5 * h / np.tan(np.radians(45.0) / 2)
    cams, imgs = [], []
    for i in range(4):
        pos = (0.2 * i, 0.0, -5.0)
        img = np.asarray(render(gt, default_camera(w, h, position=pos),
                                w, h, SETTINGS).image)
        cams.append(CameraData(id=i, position=np.asarray(pos, np.float32),
                               rotation=np.eye(3, dtype=np.float32),
                               fx=fy, fy=fy, width=w, height=h,
                               img_name=f"v{i}.png"))
        imgs.append({"name": f"v{i}.png", "image": img, "width": w,
                     "height": h})
    cfg = TrainerConfig(densify=DensifyPruneConfig(
        schedule=DensifySchedule(enabled=True, warmup_iterations=2,
                                 interval=2, stop_iterations=10),
        metric_views=2, clone_threshold_count=1, prune_opacity=0.005,
        max_new_points_per_step=8))
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh2 = Mesh(devs, ("dp", "band"))
    tr = GsTrainer(random_scene(8, seed=85), cams, imgs, cfg, SETTINGS,
                   mesh=mesh2, initial_capacity=64)
    assert tr.n_step_views == 2 and tr.d_band == 4

    losses = [float(tr.step()["loss"]) for _ in range(4)]
    assert all(np.isfinite(losses))
    assert tr.last_densify_iteration is not None
    assert tr.num_points == int(tr.scene.num_alive()) > 0


@pytest.mark.slow
def test_gs_trainer_nan_rollback(mesh):
    """Failure recovery on the fully-sharded path: the rollback restores a
    HOST optimizer snapshot (the step jits donate opt_state), and
    GsTrainer._rollback must re-shard it over the band axis before the next
    donated step."""
    from webdgs.core.camera import CameraData
    from webdgs.parallel.gs_trainer import GsTrainer
    from webdgs.train.config import (DensifyPruneConfig, DensifySchedule,
                                         TrainerConfig)

    w = h = 32
    gt = random_scene(10, seed=95)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    fy = 0.5 * h / np.tan(np.radians(45.0) / 2)
    cam = default_camera(w, h, position=(0, 0, -5.0))
    img = np.asarray(render(gt, cam, w, h, SETTINGS).image)
    cams = [CameraData(id=0, position=np.zeros(3, np.float32),
                       rotation=np.eye(3, dtype=np.float32),
                       fx=fy, fy=fy, width=w, height=h)]
    imgs = [{"name": "v0", "image": img, "width": w, "height": h}]
    cfg = TrainerConfig(max_iterations=100, densify=DensifyPruneConfig(
        schedule=DensifySchedule(enabled=False)))
    tr = GsTrainer(random_scene(8, seed=96), cams, imgs, cfg, SETTINGS,
                   mesh=mesh, initial_capacity=64)
    tr.SNAPSHOT_INTERVAL = 2

    poisoned = {"done": False}
    orig_step = tr.step

    def step_with_poison():
        m = orig_step()
        if tr.iteration == 4 and not poisoned["done"]:
            poisoned["done"] = True
            m = dict(m, loss=jnp.float32(np.nan))
        return m

    tr.step = step_with_poison
    logs = []
    tr.train(num_iterations=8, log_every=0, log_fn=logs.append)
    assert poisoned["done"]
    assert any("rolling back" in s for s in logs), logs
    # training continued past the rollback with finite, band-sharded state
    assert np.isfinite(float(tr.last_metrics["loss"]))
    assert np.isfinite(np.asarray(tr.scene.means)).all()
    from jax.sharding import PartitionSpec as P
    assert tr.opt_state.m.sharding.spec == P(tr.band_axis)


def test_gaussian_sharded_render_f16_class(mesh):
    """Default f16 entry exchange (halved ICI bytes, tile-relative
    centers): the frame must match single-device at the f16 class — the
    precision the reference stores ALL splat attributes in."""
    from webdgs.parallel.sharding import render_gaussian_sharded

    w, h = 64, 64
    scene = random_scene(80, seed=25)
    d = len(mesh.devices.reshape(-1))
    scene = scene.pad_to(-(-scene.capacity // d) * d)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    single = np.asarray(render(scene, cam, w, h, SETTINGS).image)
    assert SETTINGS.exchange_f16
    sharded, dropped = render_gaussian_sharded(scene, cam, w, h, mesh,
                                               SETTINGS)
    assert int(dropped) == 0
    err = np.abs(np.asarray(sharded) - single)
    assert err.max() < 2e-2, err.max()
    assert err.mean() < 2e-4, err.mean()


@pytest.mark.slow
def test_gs_train_step_f16_class(mesh):
    """Fully-sharded step with the default f16 exchange: the update must
    stay within the f16 class of the single-device step.  Only the FORWARD
    entry rows cross the wire as f16 — the autodiff transpose deliberately
    sends cotangents in f32 (see exchange_bwd in parallel/sharding.py), so
    the error here is the forward quantization alone."""
    from webdgs.parallel.sharding import gs_train_step
    from webdgs.train.step import train_step

    w, h = 64, 64
    d = len(mesh.devices.reshape(-1))
    scene = random_scene(64, seed=27)
    scene = scene.pad_to(-(-scene.capacity // d) * d)
    gt = random_scene(30, seed=28)
    gt = gt.replace(opacity_logits=gt.opacity_logits + 2.0)
    cam = default_camera(w, h, position=(0.0, 0.0, -5.0))
    target = render(gt, cam, w, h, SETTINGS).image
    hp = AdamHyperparameters()
    cfg = LossConfig()
    opt = init_adam_state(scene.params())

    ref_scene, _, ref_m = train_step(
        scene, opt, cam, target, img_w=w, img_h=h, loss_cfg=cfg, hp=hp,
        settings=SETTINGS)
    new_scene, _, m = gs_train_step(
        scene, opt, cam, target, mesh, img_w=w, img_h=h, loss_cfg=cfg,
        hp=hp, settings=SETTINGS)

    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=2e-3)
    # Adam is scale-invariant, so f16 FORWARD rounding can flip the update
    # direction of parameters whose net gradient nearly cancels (the
    # reference's 1e-6 fixed-point gradient atomics have the same
    # property).  Bound: nearly all elements tight, the rest within ~2
    # Adam steps, and the updated scenes render the same frame.
    step_scale = {"means": 16e-5, "quats": 1e-3, "log_scales": 5e-3,
                  "opacity_logits": 5e-2, "sh": 2.5e-3}
    for k in ref_scene.params():
        ref_p = np.asarray(ref_scene.params()[k])
        new_p = np.asarray(new_scene.params()[k])
        err = np.abs(new_p - ref_p)
        assert np.mean(err <= 5e-3 * np.abs(ref_p) + 1e-5) > 0.97, k
        assert err.max() <= 8.0 * step_scale[k], (k, err.max())
    f_ref = np.asarray(render(ref_scene, cam, w, h, SETTINGS).image)
    f_new = np.asarray(render(new_scene, cam, w, h, SETTINGS).image)
    assert np.abs(f_new - f_ref).max() < 2e-2
