"""The training orchestrator.

The analogue of the reference's ``Trainer`` (src/trainer.ts): owns the
scene + optimizer state, picks a random (camera, image) pair per step
(trainer.ts:573-575 pairs them by array index), runs the jitted train step,
and fires the densify/prune schedule (warmup/interval/stop,
trainer.ts:593-601).

Differences by design:
  * densify events never reallocate or rebuild pipelines — the scene is
    capacity-padded with an alive mask; capacity grows geometrically
    (with one recompile) only when headroom runs out, replacing the
    reference's swap-request/rebuild protocol (trainer.ts:201-237,466-496);
  * the only device->host readback is the per-event point-count stat, the
    same single readback the reference performs (trainer.ts:440-457);
  * importance metrics render every sampled view with its own camera,
    fixing SURVEY.md Q1;
  * checkpointing and PSNR reporting exist (the reference has neither).
"""

from __future__ import annotations

import functools
import random
import time

import jax
import jax.numpy as jnp
import numpy as np

from webdgs.config import (DEFAULT_SETTINGS, RenderSettings,
                                quantize_budget)
from webdgs.core.camera import Camera, CameraData, make_camera
from webdgs.core.scene import GaussianScene
from webdgs.ops.adam import AdamState, init_adam_state
from webdgs.ops.densify import densify_prune
from webdgs.ops.importance import multiview_importance_counts
from webdgs.ops.loss import pixel_loss_gradient
from webdgs.render.renderer import render, render_compiled
from webdgs.train.config import TrainerConfig
from webdgs.train.step import train_step


def _round_capacity(n: int, granule: int = 4096) -> int:
    return max(-(-n // granule) * granule, granule)


def _group_views(cameras: list[CameraData], images: list[dict]) -> dict:
    """Group (camera, image) pairs by resolution; jit caches per (W, H)."""
    groups: dict[tuple[int, int], dict] = {}
    for cam_data, img in zip(cameras, images):
        res = (img["width"], img["height"])
        g = groups.setdefault(res, {"cams": [], "imgs": []})
        g["cams"].append(make_camera(cam_data, *res))
        g["imgs"].append(img["image"])
    for res, g in groups.items():
        g["cams"] = jax.tree.map(lambda *xs: jnp.stack(xs), *g["cams"])
        g["imgs"] = jnp.asarray(np.stack(g["imgs"], axis=0))
        g["count"] = g["imgs"].shape[0]
    return groups


class Trainer:
    def __init__(self, scene: GaussianScene, cameras: list[CameraData],
                 images: list[dict], config: TrainerConfig = TrainerConfig(),
                 settings: RenderSettings = DEFAULT_SETTINGS,
                 initial_capacity: int | None = None,
                 mesh=None):
        """``mesh``: optional jax.sharding.Mesh; when given, every step
        trains on a view batch of mesh-size views data-parallel across the
        devices (gradients psum-reduced)."""
        if len(cameras) != len(images):
            raise ValueError(
                f"cameras ({len(cameras)}) and images ({len(images)}) must "
                "pair by index")
        self.config = config
        self.settings = settings
        self.mesh = mesh
        lam = (config.loss.lambda_l1 + config.loss.lambda_l2
               + config.loss.lambda_dssim)
        if not 0.99 <= lam <= 1.01:
            # the reference warns when the loss weights do not sum to 1
            # (src/main.ts:301-321)
            import warnings
            warnings.warn(f"loss weights sum to {lam:.3f}, expected ~1.0",
                          stacklevel=2)
        self.rng = random.Random(config.seed)
        self.key = jax.random.PRNGKey(config.seed)

        self.groups = _group_views(cameras, images)

        self.num_points = int(scene.num_alive())
        cap = initial_capacity or self._round(scene.capacity)
        self.scene = scene.pad_to(cap)
        self.opt_state = init_adam_state(self.scene.params())

        self.iteration = 0
        self._entry_cap_value: int | None = None
        self._entry_cap_peak = 0.0
        self.step_ms = 0.0
        self.iters_per_sec = 0.0
        self._rate_mark: tuple[int, float] | None = None
        self.last_densify_iteration: int | None = None
        self.last_metrics: dict = {}

    def _round(self, n: int) -> int:
        """Capacity rounding policy (subclasses may add divisibility
        constraints, e.g. the sharded trainer needs mesh-divisible
        capacities)."""
        return _round_capacity(n)

    # every cached_property below closes over self.config/self.settings;
    # set_config invalidates them so live mutation takes effect (the
    # reference mutates all three configs mid-training from sliders,
    # src/trainer.ts:248-283)
    _CONFIG_CLOSURES = ("_indexed_step", "_indexed_dp_step", "_densify_fn",
                        "_eval_fn", "_loss_map_fn")

    def set_config(self, updates) -> None:
        """Apply a deep-partial config update mid-training, like the
        reference's slider-driven setters (src/trainer.ts:248-283 accept
        deep partials; src/main.ts:301-372 wires the sliders).

        ``updates``: a dict of deep-partial overrides (e.g.
        ``{"adam": {"lr_pos": 0.0}}``) or a full TrainerConfig.  Rebuilds
        the cached jitted closures so the next step uses the new values."""
        from webdgs.train.config import TrainerConfig, _merge_dataclass
        if isinstance(updates, TrainerConfig):
            new = updates
        else:
            new = _merge_dataclass(self.config, updates)
        if new == self.config:
            # no-op updates (e.g. a UI slider re-posting its current value
            # every input tick) must not invalidate the jitted closures —
            # each invalidation costs a full train-step retrace
            return
        self.config = new
        for name in self._CONFIG_CLOSURES:
            self.__dict__.pop(name, None)

    def set_settings(self, updates) -> None:
        """Apply a partial RenderSettings update mid-training (the
        reference's gaussian-scale knob, src/main.ts:369-372)."""
        import dataclasses as _dc
        if isinstance(updates, RenderSettings):
            self.settings = updates
        else:
            self.settings = _dc.replace(self.settings, **updates)
        for name in self._CONFIG_CLOSURES:
            self.__dict__.pop(name, None)

    # ------------------------------------------------------------------
    def _pick_group(self):
        total = sum(g["count"] for g in self.groups.values())
        r = self.rng.randrange(total)
        for res, g in self.groups.items():
            if r < g["count"]:
                return res, g
            r -= g["count"]
        raise AssertionError

    @functools.cached_property
    def _indexed_step(self):
        # opt_state is donated: the Adam moments are consumed only by the
        # step itself (rollback snapshots hold HOST copies — _snapshot), so
        # XLA aliases the input buffers into the outputs instead of holding
        # input+output moments live at once (~2/3 of the training state)
        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("img_w", "img_h", "entry_cap"))
        def run(scene, opt_state, cams, imgs, idx, img_w, img_h, entry_cap):
            camera = jax.tree.map(lambda x: x[idx], cams)
            return train_step(
                scene, opt_state, camera, imgs[idx], img_w=img_w,
                img_h=img_h, loss_cfg=self.config.loss, hp=self.config.adam,
                settings=self.settings, entry_capacity=entry_cap)
        return run

    # adaptive tile-entry capacity: the static budget every O(entries) op
    # (sort, gathers, kernels) is sized by.  Starts at the reference-style
    # heuristic, then follows the observed per-frame entry count with head-
    # room (one readback + possible recompile every `interval` steps).
    # Headroom trades step time against drop/recompile frequency — most
    # of the step is O(capacity).  1.2 covers cross-view entry variance;
    # densify-driven jumps are handled proactively by
    # _grow_entry_cap_for_swap, not by this margin.
    ENTRY_CAP_INTERVAL = 50
    ENTRY_CAP_HEADROOM = 1.2
    # the peak decays between observations so a transient early spike (e.g.
    # initial densification) does not permanently oversize every O(entries)
    # op — without it the shrink branch below could never fire
    ENTRY_CAP_DECAY = 0.9

    def _entry_cap(self) -> int | None:
        return self._entry_cap_value

    def _maybe_adapt_entry_cap(self, metrics) -> None:
        # adapt right after the first step (the heuristic capacity is often
        # several x the real need) and then every interval
        if self.iteration != 1 and self.iteration % self.ENTRY_CAP_INTERVAL:
            return
        observed = float(metrics["tile_entries"])
        self._entry_cap_peak = max(observed,
                                   self.ENTRY_CAP_DECAY * self._entry_cap_peak)
        chunk = self.settings.chunk
        want = quantize_budget(self._entry_cap_peak * self.ENTRY_CAP_HEADROOM,
                               chunk, chunk * 8)
        cur = self._entry_cap_value
        # grow whenever short on headroom; shrink only when far oversized
        if cur is None or want > cur or want < cur // 2:
            self._entry_cap_value = want

    @functools.cached_property
    def _indexed_dp_step(self):
        from webdgs.parallel.sharding import dp_train_step

        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("img_w", "img_h", "entry_cap"))
        def run(scene, opt_state, cams, imgs, idxs, img_w, img_h, entry_cap):
            cam_batch = jax.tree.map(lambda x: x[idxs], cams)
            return dp_train_step(
                scene, opt_state, cam_batch, imgs[idxs], self.mesh,
                img_w=img_w, img_h=img_h, loss_cfg=self.config.loss,
                hp=self.config.adam, settings=self.settings,
                entry_capacity=entry_cap)
        return run

    def step(self) -> dict:
        """One training iteration (trainer.ts:568-660)."""
        t0 = time.perf_counter()
        (w, h), g = self._pick_group()

        if self.mesh is not None and self.mesh.devices.size > 1:
            d = self.mesh.devices.size
            # numpy (not jnp): a jnp constructor here is an EAGER device op
            # dispatched every step (~ms of host time); jit transfers the
            # numpy value as part of the call instead
            idxs = np.asarray(
                [self.rng.randrange(g["count"]) for _ in range(d)],
                dtype=np.int32)
            self.scene, self.opt_state, metrics = self._indexed_dp_step(
                self.scene, self.opt_state, g["cams"], g["imgs"], idxs,
                w, h, self._entry_cap())
            self.iteration += 1
            self._maybe_adapt_entry_cap(metrics)
        else:
            idx = self.rng.randrange(g["count"])
            self.scene, self.opt_state, metrics = self._indexed_step(
                self.scene, self.opt_state, g["cams"], g["imgs"],
                np.int32(idx), w, h, self._entry_cap())
            self.iteration += 1
            self._maybe_adapt_entry_cap(metrics)

        next_it = self.iteration
        if self.config.densify.schedule.should_densify(next_it):
            self._run_densify(w, h)

        self._finish_step(t0, metrics)
        return metrics

    RATE_SYNC_INTERVAL = 100

    def _finish_step(self, t0: float, metrics: dict) -> None:
        """Step timing + iters/s meter (trainer.ts:648-651), shared with
        the sharded trainer.

        Per-step wall time measures only DISPATCH under async execution
        (the jitted step returns before the device finishes), so the
        honest rate is iterations over wall time between real device
        syncs: every RATE_SYNC_INTERVAL steps one loss scalar is fetched
        and the rate spans the window — densify events and adaptation
        readbacks included."""
        self.step_ms = (time.perf_counter() - t0) * 1e3
        if self.iteration % self.RATE_SYNC_INTERVAL == 0:
            _ = float(metrics["loss"])  # block until this step finished
            now = time.perf_counter()
            if self._rate_mark is not None:
                it0, tm = self._rate_mark
                if self.iteration > it0 and now > tm:
                    self.iters_per_sec = (self.iteration - it0) / (now - tm)
            self._rate_mark = (self.iteration, now)
        self.last_metrics = metrics

    # ------------------------------------------------------------------
    @functools.cached_property
    def _densify_fn(self):
        cfg = self.config.densify

        @functools.partial(jax.jit, static_argnames=("mw", "mh"))
        def run(scene, opt_state, cams, targets, view_idx, key, mw, mh):
            cam_batch = jax.tree.map(lambda x: x[view_idx], cams)
            t_batch = targets[view_idx]
            t_small = jax.image.resize(
                t_batch, (t_batch.shape[0], mh, mw, 3), "linear")
            counts = multiview_importance_counts(
                scene.params(), scene.alive, scene.sh_deg, cam_batch,
                t_small, mw, mh, cfg.metric_threshold, self.settings)
            return densify_prune(scene, opt_state, counts, cfg, key)
        return run

    def _metric_camera(self, cams: Camera, mw: int, mh: int) -> Camera:
        """Re-derive a stacked camera batch at the metrics viewport, exactly
        as the reference rebuilds the camera at the smaller canvas
        (trainer.ts:398-401, camera.ts:138-146): fovY is preserved, focal
        comes from fovY and the metric height, and fovX is re-derived from
        that focal at the metric width.

        The projection entries that depend on the viewport are
        p00 = 2*focal/width and p11 = -2*focal/height (camera.ts:29-56);
        everything else (z rows) is viewport-independent, so this matches
        ``make_camera(data, mw, mh)`` exactly even when the aspect ratio
        changes (e.g. odd dimensions under integer downscale)."""
        h = cams.viewport[:, 1]
        f_m = cams.focal[:, 1] * (mh / h)  # = 0.5*mh/tan(fovY/2)
        # jnp.asarray: camera leaves may be numpy (make_camera builds host
        # cameras; only the trainer's grouped batches live on device)
        proj = jnp.asarray(cams.proj)
        proj = proj.at[:, 0, 0].set(2.0 * f_m / mw)
        proj = proj.at[:, 1, 1].set(-2.0 * f_m / mh)
        return Camera(
            view=cams.view,
            proj=proj,
            cam_pos=cams.cam_pos,
            focal=jnp.stack([f_m, f_m], axis=-1),
            viewport=jnp.broadcast_to(
                jnp.array([mw, mh], jnp.float32), cams.viewport.shape),
        )

    def _grow_capacity(self) -> None:
        """Grow scene+optimizer capacity if densify headroom is short (one
        recompile, the analogue of the reference's buffer swap)."""
        cfg = self.config.densify
        needed = self.num_points + cfg.max_new_points_per_step
        budget = cfg.max_buffer_bytes // 96  # sh-buffer stride analogue
        if needed > self.scene.capacity and self.scene.capacity < budget:
            new_cap = self._round(min(int(needed * 1.5), budget))
            if new_cap > self.scene.capacity:
                pad = new_cap - self.scene.capacity
                self.scene = self.scene.pad_to(new_cap)
                self.opt_state = AdamState(
                    m=jnp.pad(self.opt_state.m, [(0, pad), (0, 0)]),
                    v=jnp.pad(self.opt_state.v, [(0, pad), (0, 0)]),
                    iteration=self.opt_state.iteration)
                self._on_state_resize()

    def _on_state_resize(self) -> None:
        """Hook after a capacity change (the sharded trainer re-pins
        shardings here)."""

    def _run_densify(self, w: int, h: int) -> None:
        cfg = self.config.densify
        g = self.groups[(w, h)]
        downscale = max(1, int(cfg.metric_downscale))
        mw, mh = max(1, w // downscale), max(1, h // downscale)

        self._grow_capacity()

        n_views = min(max(1, cfg.metric_views), g["count"])
        view_idx = jnp.asarray(
            self.rng.sample(range(g["count"]),
                            k=n_views), dtype=jnp.int32)
        self.key, sub = jax.random.split(self.key)
        cams_m = self._metric_camera(g["cams"], mw, mh)
        result = self._densify_fn(self.scene, self.opt_state, cams_m,
                                  g["imgs"], view_idx, sub, mw, mh)

        # the single host readback per event (trainer.ts:447-457)
        out_total = int(result.out_total)
        in_alive = int(result.in_alive)
        if out_total == 0 or out_total == in_alive:
            return  # reference skips the swap (trainer.ts:460-464)
        self.scene = result.scene
        self.opt_state = result.opt_state
        self.num_points = out_total
        self.last_densify_iteration = self.iteration
        self._grow_entry_cap_for_swap(out_total, in_alive)

    def _grow_entry_cap_for_swap(self, out_total: int, in_alive: int) -> None:
        """Entry counts scale ~linearly with alive splats: grow the entry-cap
        peak proactively with a densify swap instead of waiting for the next
        adaptation readback (up to ENTRY_CAP_INTERVAL-1 steps away) to
        observe the jump — this is what makes a tight ENTRY_CAP_HEADROOM
        safe across densify events (the reference instead resizes
        maxTileEntries from the new point count at the swap,
        tiled-forward-pass.ts:137-158)."""
        if not (out_total > in_alive > 0):
            return
        self._entry_cap_peak *= out_total / in_alive
        chunk = self.settings.chunk
        want = quantize_budget(self._entry_cap_peak * self.ENTRY_CAP_HEADROOM,
                               chunk, chunk * 8)
        if self._entry_cap_value is None or want > self._entry_cap_value:
            self._entry_cap_value = want

    # ------------------------------------------------------------------
    def next_densify_iteration(self) -> int | None:
        """trainer.ts:550-565."""
        s = self.config.densify.schedule
        if not s.enabled:
            return None
        i = self.iteration
        if i >= s.stop_iterations:
            return None
        if i < s.warmup_iterations:
            return min(s.warmup_iterations, s.stop_iterations)
        interval = max(1, s.interval)
        k = -(-(i + 1 - s.warmup_iterations) // interval)
        nxt = s.warmup_iterations + k * interval
        return nxt if nxt <= s.stop_iterations else None

    @functools.cached_property
    def _eval_fn(self):
        """One jitted device loop per resolution group (``lax.map`` keeps
        memory at a single view while avoiding the old per-view host
        dispatch and re-jit; one compile per (W, H))."""
        from webdgs.ops.loss import loss_metrics, ssim

        @functools.partial(jax.jit,
                           static_argnames=("img_w", "img_h", "entry_cap"))
        def run(scene, cams, imgs, img_w, img_h, entry_cap):
            def one(cam_img):
                cam, img = cam_img
                pred = render(scene, cam, img_w, img_h, self.settings,
                              entry_capacity=entry_cap).image
                m = loss_metrics(pred, img, self.config.loss)
                return jnp.stack([m["psnr"], m["l1"], ssim(pred, img)])
            return jax.lax.map(one, (cams, imgs))  # (V, 3)
        return run

    def evaluate(self, max_views: int | None = None,
                 views: tuple[list, list] | None = None,
                 groups: dict | None = None) -> dict:
        """Mean PSNR / L1 / SSIM over dataset views — quality reporting the
        reference never had (SURVEY.md section 5: no PSNR/SSIM anywhere).

        ``views``: optional (cameras, images) lists to evaluate instead of
        the training set (e.g. a held-out test split).  ``groups``: a
        pre-grouped ``_group_views`` result — callers that evaluate the
        same split repeatedly should group once and pass it here (grouping
        re-stacks and re-uploads every target image)."""
        if groups is None:
            groups = (self.groups if views is None
                      else _group_views(views[0], views[1]))
        per_view = []
        remaining = max_views
        for (w, h), g in groups.items():
            if remaining is not None and remaining <= 0:
                break
            take = g["count"] if remaining is None else min(g["count"],
                                                            remaining)
            # Evaluate a power-of-two bucket >= take and slice host-side:
            # slicing the device arrays to `take` itself would compile a
            # fresh lax.map per distinct count, while always evaluating the
            # whole group would make evaluate(max_views=k) cost O(group)
            # device work.  Buckets bound the compiles at log2(count) per
            # resolution AND the work at < 2x the request.
            b = min(1 << max(take - 1, 0).bit_length(), g["count"])
            cams_b, imgs_b = g["cams"], g["imgs"]
            if b < g["count"]:
                cams_b = jax.tree.map(lambda x: x[:b], cams_b)
                imgs_b = imgs_b[:b]
            vals = self._eval_fn(self.scene, cams_b, imgs_b,
                                 w, h, self._entry_cap())
            per_view.append(np.asarray(vals)[:take])
            if remaining is not None:
                remaining -= take
        if not per_view:
            return {"psnr": float("nan"), "l1": float("nan"),
                    "ssim": float("nan"), "views": 0}
        allv = np.concatenate(per_view, axis=0)
        return {"psnr": float(allv[:, 0].mean()),
                "l1": float(allv[:, 1].mean()),
                "ssim": float(allv[:, 2].mean()),
                "views": int(allv.shape[0])}

    def render_view(self, index: int):
        """Render one dataset view at full resolution."""
        flat = [(res, g, i) for res, g in self.groups.items()
                for i in range(g["count"])]
        (w, h), g, i = flat[index]
        cam = jax.tree.map(lambda x: x[i], g["cams"])
        return render_compiled(self.scene, cam, img_w=w, img_h=h,
                               settings=self.settings).image

    @functools.cached_property
    def _loss_map_fn(self):
        @functools.partial(jax.jit,
                           static_argnames=("img_w", "img_h", "entry_cap"))
        def run(scene, cam, target, img_w, img_h, entry_cap):
            img = render(scene, cam, img_w, img_h, self.settings,
                         entry_capacity=entry_cap).image
            return jnp.abs(pixel_loss_gradient(img, target,
                                               self.config.loss))
        return run

    def visualize_loss(self, index: int):
        """Per-pixel loss-gradient map for a dataset view, the analogue of
        the reference's show-loss debug view (trainer.ts:695-768).  Jitted
        (one compile per resolution group)."""
        flat = [(res, g, i) for res, g in self.groups.items()
                for i in range(g["count"])]
        (w, h), g, i = flat[index]
        cam = jax.tree.map(lambda x: x[i], g["cams"])
        return self._loss_map_fn(self.scene, cam, g["imgs"][i], w, h,
                                 self._entry_cap())

    def set_dataset(self, cameras: list[CameraData],
                    images: list[dict]) -> None:
        """Swap the training dataset mid-session — the reference's
        ``trainer.setDataset`` (src/trainer.ts:239-242, wired from the
        browser file inputs at src/main.ts:419,449).  Like the reference,
        this replaces the views and leaves the scene/optimizer/iteration
        untouched; the next step draws from the new set.  The jitted step
        closures take the view stacks as arguments, so no retrace is
        needed unless the new views introduce a new resolution group."""
        if len(cameras) != len(images):
            raise ValueError(
                f"cameras ({len(cameras)}) and images ({len(images)}) must "
                "pair by index")
        if not cameras:
            raise ValueError("dataset must contain at least one view")
        self.groups = _group_views(cameras, images)
        self.dataset_cameras = cameras

    def resume_from(self, scene, opt_state, iteration: int) -> None:
        """Restore training state from a checkpoint (the reference cannot
        resume at all — a page reload loses everything, SURVEY.md sec 5)."""
        cap = self._round(scene.capacity)
        self.scene = scene.pad_to(cap)
        if opt_state is not None:
            pad = cap - opt_state.m.shape[0]
            if pad > 0:
                opt_state = AdamState(
                    m=jnp.pad(opt_state.m, [(0, pad), (0, 0)]),
                    v=jnp.pad(opt_state.v, [(0, pad), (0, 0)]),
                    iteration=opt_state.iteration)
            self.opt_state = opt_state
        else:
            self.opt_state = init_adam_state(self.scene.params())
        self.iteration = int(iteration)
        self.num_points = int(self.scene.num_alive())

    # failure detection / recovery (the reference has none — a page reload
    # loses everything, SURVEY.md section 5): snapshot the training state
    # in memory every interval; a non-finite loss rolls back to the last
    # good state and continues with fresh view draws
    SNAPSHOT_INTERVAL = 250
    MAX_ROLLBACKS = 5

    def _snapshot(self) -> None:
        # the optimizer snapshot is pulled to HOST memory: the step jits
        # donate opt_state, so a device-resident snapshot would be the very
        # buffer the next step invalidates.  (The scene is NOT donated — the
        # live viewer thread and evaluate() share its buffers — so its
        # device reference stays valid.)  One D2H of the moments per
        # SNAPSHOT_INTERVAL; rollback re-uploads lazily via the next step.
        self._last_good = (self.scene, jax.device_get(self.opt_state),
                           self.iteration, self.num_points)

    def _rollback(self) -> None:
        scene, opt, it, npts = self._last_good
        self.scene, self.opt_state = scene, opt
        self.iteration, self.num_points = it, npts

    def train(self, num_iterations: int | None = None,
              log_every: int = 100, log_fn=print,
              checkpoint_every: int = 0,
              checkpoint_path: str | None = None,
              profile_dir: str | None = None) -> dict:
        if profile_dir:
            jax.profiler.start_trace(profile_dir)
        rollbacks = 0
        self._snapshot()
        # the loss is already a host float at every log line, so check
        # finiteness at log_every cadence (a divergence is noticed within
        # log_every steps) while snapshots stay at SNAPSHOT_INTERVAL
        check_every = min(log_every or self.SNAPSHOT_INTERVAL,
                          self.SNAPSHOT_INTERVAL)
        try:
            n = num_iterations or self.config.max_iterations
            for _ in range(n):
                metrics = self.step()
                it = self.iteration
                if (it % check_every == 0
                        or it % self.SNAPSHOT_INTERVAL == 0):
                    loss = float(metrics["loss"])
                    if not np.isfinite(loss):
                        rollbacks += 1
                        if rollbacks > self.MAX_ROLLBACKS:
                            raise FloatingPointError(
                                f"loss non-finite after {rollbacks} "
                                "consecutive rollbacks; training diverged")
                        if log_fn:
                            log_fn(f"iter {self.iteration}: loss={loss} — "
                                   f"rolling back to iteration "
                                   f"{self._last_good[2]}")
                        self._rollback()
                        continue
                    if it % self.SNAPSHOT_INTERVAL == 0:
                        rollbacks = 0  # a clean snapshot resets the budget
                        self._snapshot()
                if log_every and self.iteration % log_every == 0 and log_fn:
                    log_fn(f"iter {self.iteration}: "
                           f"loss={float(metrics['loss']):.4f} "
                           f"psnr={float(metrics['psnr']):.2f} "
                           f"points={self.num_points} "
                           f"({self.iters_per_sec:.1f} it/s)")
                if (checkpoint_every and checkpoint_path
                        and self.iteration % checkpoint_every == 0):
                    from webdgs.io.checkpoint import save_checkpoint
                    save_checkpoint(checkpoint_path, self.scene,
                                    self.opt_state,
                                    iteration=self.iteration)
                if self.iteration >= self.config.max_iterations:
                    break
        finally:
            if profile_dir:
                jax.profiler.stop_trace()
        return {k: float(v) for k, v in self.last_metrics.items()}
