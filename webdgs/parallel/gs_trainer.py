"""Fully-sharded training orchestration: densify/prune event + Trainer mode
for the gaussian-sharded training step (1M+ Gaussians over several cards).

The reference's densify event reallocates GPU buffers and rebuilds the whole
render graph on one device (src/renderers/densify-prune.ts:458-678 + the
swap protocol src/trainer.ts:373-497).  Sharded over a mesh the event
keeps every per-Gaussian array local to its shard:

* **decide/cap are globally consistent**: each shard decides locally, one
  all-gather of the D per-shard output totals gives every shard its global
  output offset, and the capacity cap (densify-prune-cap.wgsl semantics)
  clips against the global budget at exactly the offsets the single-device
  event would use.  The per-source random rows come from one global draw
  sliced per shard, so the OUTPUT SET (sources, actions, transforms) is
  bit-identical to the single-device event.
* **no row exchange**: each shard compacts its survivors into its own
  slots.  Redistribution is unnecessary because capacity is padded and dead
  slots are culled in projection; only slot *placement* differs from the
  single-device event (a permutation).  A shard that would overflow its
  local capacity degrades boundary clones/splits to keeps (the same
  degrade rule the reference applies at its global budget); the Trainer's
  capacity growth restores headroom at the next event.
* **metric replay is view-parallel**: the importance counts need global
  compositing (n_contrib depends on every Gaussian), so parameters are
  all-gathered once per event (params only — moments stay sharded) and the
  ~10 metric views are strided across the band axis, one (N,) psum merges
  the counts.  This fixes reference quirk Q1 (all views rendered with the
  last camera) and parallelizes what the reference serializes.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from webdgs.core.scene import GaussianScene
from webdgs.ops.adam import AdamState
from webdgs.ops.densify import (DensifyResult, cap_counts,
                                    compact_transform, decide, densify_rng)
from webdgs.ops.importance import view_importance_counts
from webdgs.train.config import DensifyPruneConfig
from webdgs.config import quantize_budget
from webdgs.train.trainer import Trainer


def rebalance_shards(scene: GaussianScene, opt_state: AdamState,
                     d: int) -> tuple[GaussianScene, AdamState]:
    """Spread the alive rows round-robin across the ``d`` shards (alive row
    k -> shard k mod d) so every shard carries an equal share of live
    Gaussians AND an equal share of free slots.

    Shard-local densification creates imbalance (a pruning-heavy shard
    empties while a cloning-heavy one fills); without headroom a full shard
    must degrade its clones/splits at the local slot cap even when global
    capacity remains.  Rebalancing before each event keeps the local cap
    from binding unless the *global* budget binds too.  One global
    permutation gather per leaf — O(N) like the event's own parameter
    all-gather, once per densify interval.
    """
    cap = scene.capacity
    if cap % d != 0:
        raise ValueError(f"capacity {cap} not divisible by {d}")
    n_loc = cap // d
    alive = scene.alive
    a_rank = jnp.cumsum(alive) - 1  # rank among alive rows
    d_rank = jnp.cumsum(~alive) - 1  # rank among dead rows
    dest_alive = (a_rank % d) * n_loc + a_rank // d

    # dead rows fill the remaining slots in rank order
    slot_ids = jnp.arange(cap, dtype=jnp.int32)
    used = jnp.zeros((cap,), bool).at[
        jnp.where(alive, dest_alive, cap)].set(True, mode="drop")
    free_rank = jnp.cumsum(~used) - 1
    free_slot_of_rank = jnp.zeros((cap,), jnp.int32).at[
        jnp.where(~used, free_rank, cap)].set(slot_ids, mode="drop")
    dest = jnp.where(alive, dest_alive, free_slot_of_rank[d_rank])
    src_of = jnp.zeros((cap,), jnp.int32).at[dest].set(
        slot_ids, unique_indices=True)

    def mv(x):
        return x[src_of]

    new_scene = scene.replace(
        **{k: mv(v) for k, v in scene.params().items()},
        alive=alive[src_of])
    new_opt = AdamState(m=jax.tree.map(mv, opt_state.m),
                        v=jax.tree.map(mv, opt_state.v),
                        iteration=opt_state.iteration)
    return new_scene, new_opt


def gs_densify_event(scene: GaussianScene, opt_state: AdamState,
                     cameras, targets, view_idx, key, mesh, *,
                     mw: int, mh: int, cfg: DensifyPruneConfig,
                     settings) -> DensifyResult:
    """One densify/prune event with the scene and optimizer state sharded
    over the Gaussian axis (1D band mesh, or the band axis of a 2D dp x band
    mesh).  Matches the single-device ``densify_prune`` output set exactly
    (see module docstring); only slot placement differs.

    cameras: stacked metric-viewport Camera pytree; targets: (V, H, W, 3)
    full-res ground truth (resized per view inside); view_idx: (k,) sampled
    view indices.
    """
    axis = mesh.axis_names[-1]
    d = mesh.shape[axis]
    if scene.capacity % d != 0:
        raise ValueError(f"capacity {scene.capacity} not divisible by {d}")
    n_loc = scene.capacity // d
    n_glob = scene.capacity
    n_views = view_idx.shape[0]
    sh_deg = scene.sh_deg

    state_specs = AdamState(m=P(axis), v=P(axis), iteration=P())
    out_specs = DensifyResult(
        scene=P(axis), opt_state=state_specs, out_total=P(), in_alive=P(),
        n_cloned=P(), n_split=P(), n_pruned=P())

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), state_specs, P(), P(), P(), P()),
        out_specs=out_specs, check_vma=False)
    def event(scene_l, opt_l, cams, tgts, vidx, k):
        b = jax.lax.axis_index(axis)

        # ---- importance counts: replay needs the full scene (n_contrib is
        # a global-compositing quantity); gather params once, stride the
        # metric views over the band axis, psum the counts ----
        full_params = {k2: jax.lax.all_gather(v, axis, tiled=True)
                       for k2, v in scene_l.params().items()}
        full_alive = jax.lax.all_gather(scene_l.alive, axis, tiled=True)

        vpd = -(-n_views // d)

        def body(i, acc):
            v = i * d + b
            valid = v < n_views
            vc = jnp.clip(v, 0, n_views - 1)
            cam_i = jax.tree.map(lambda x: x[vidx[vc]], cams)
            t_small = jax.image.resize(tgts[vidx[vc]], (mh, mw, 3), "linear")
            c = view_importance_counts(
                full_params, full_alive, sh_deg, cam_i, t_small, mw, mh,
                cfg.metric_threshold, settings)
            return acc + jnp.where(valid, c, 0.0)

        counts_full = jax.lax.psum(
            jax.lax.fori_loop(0, vpd, body,
                              jnp.zeros((n_glob,), jnp.float32)),
            axis) / n_views
        counts_l = jax.lax.dynamic_slice_in_dim(counts_full, b * n_loc,
                                                n_loc, 0)

        # ---- decide locally; cap against the global budget at this
        # shard's global output offset (single-device cap semantics) ----
        cnt, act = decide(scene_l, counts_l, cfg)
        in_alive = jax.lax.psum(jnp.sum(scene_l.alive.astype(jnp.int32)),
                                axis)
        totals = jax.lax.all_gather(jnp.sum(cnt), axis)  # (d,)
        base = (jnp.cumsum(totals) - totals)[b]
        max_out = jnp.minimum(
            jnp.int32(n_glob),
            in_alive + jnp.int32(cfg.max_new_points_per_step))
        cnt, act, _ = cap_counts(cnt, act, max_out, base_offset=base)
        # local slot cap: a shard holds at most n_loc outputs (an extra
        # constraint the single-device event does not have; it only binds
        # when shards are imbalanced near full capacity)
        cnt, act, total_l = cap_counts(cnt, act, jnp.int32(n_loc))

        # ---- transform with the single-device RNG rows for this shard ----
        jit_full, spl_full = densify_rng(k, n_glob)
        jit_l = jax.lax.dynamic_slice_in_dim(jit_full, b * n_loc, n_loc, 0)
        spl_l = jax.lax.dynamic_slice_in_dim(spl_full, b * n_loc, n_loc, 0)
        new_params, new_opt, valid_out = compact_transform(
            scene_l.params(), opt_l, cnt, act, total_l, jit_l, spl_l)

        live = scene_l.alive
        from webdgs.ops.densify import (ACTION_CLONE, ACTION_PRUNE,
                                            ACTION_SPLIT)
        return DensifyResult(
            scene=scene_l.with_params(new_params).replace(alive=valid_out),
            opt_state=new_opt,
            out_total=jax.lax.psum(total_l, axis),
            in_alive=in_alive,
            n_cloned=jax.lax.psum(
                jnp.sum((act == ACTION_CLONE) & live), axis),
            n_split=jax.lax.psum(jnp.sum((act == ACTION_SPLIT) & live), axis),
            n_pruned=jax.lax.psum(jnp.sum((act == ACTION_PRUNE) & live),
                                  axis),
        )

    return event(scene, opt_state, cameras, targets, view_idx, key)


class GsTrainer(Trainer):
    """Trainer mode driving the FULLY-sharded step (``gs_train_step``:
    scene + Adam state sharded over the Gaussian axis, packed entries
    exchanged to tile-band owners) with the sharded densify event — the
    complete BASELINE config-5 training loop.

    ``mesh``: 1D band mesh, or 2D ``Mesh(devs.reshape(V, B), ("dp",
    "band"))`` — the 2D form trains a batch of V views per step with the
    scene band-sharded, one O(N/B) gradient psum over dp.

    Entry and send capacities adapt from the step's observed loads
    (``entries_local_max`` / ``send_max`` metrics) with the same headroom/
    decay policy as the single-device entry cap, replacing the static
    heuristics — the sharded analogue of the reference's maxTileEntries
    resize (src/renderers/tiled-forward-pass.ts:137-158).
    """

    _CONFIG_CLOSURES = Trainer._CONFIG_CLOSURES + (
        "_indexed_gs_step", "_gs_densify_fn")

    def __init__(self, scene, cameras, images, config=None, settings=None,
                 mesh=None, initial_capacity=None):
        if mesh is None:
            raise ValueError("GsTrainer requires a mesh")
        from webdgs.config import DEFAULT_SETTINGS
        from webdgs.train.config import TrainerConfig
        self.gs_mesh = mesh
        self.band_axis = mesh.axis_names[-1]
        self.dp_axis = mesh.axis_names[0] if len(mesh.axis_names) == 2 \
            else None
        self.d_band = mesh.shape[self.band_axis]
        self.n_step_views = mesh.shape[self.dp_axis] if self.dp_axis else 1
        if initial_capacity is not None:
            # fail-fast alignment: an explicit capacity that is not band-
            # divisible would otherwise defer the error to the first step
            initial_capacity = -(-initial_capacity // self.d_band) \
                * self.d_band
        super().__init__(scene, cameras, images,
                         config or TrainerConfig(),
                         settings or DEFAULT_SETTINGS,
                         initial_capacity=initial_capacity, mesh=None)
        self._gs_entry_cap: int | None = None
        self._gs_send_cap: int | None = None
        self._send_peak = 0.0
        self._place()

    def _round(self, n: int) -> int:
        g = math.lcm(4096, self.d_band)
        return max(-(-n // g) * g, g)

    def _place(self) -> None:
        """Pin the scene/optimizer shardings: per-Gaussian leaves sharded
        over the band axis, scalars replicated."""
        sh_g = NamedSharding(self.gs_mesh, P(self.band_axis))
        sh_r = NamedSharding(self.gs_mesh, P())
        put = functools.partial(jax.device_put, device=sh_g)
        self.scene = jax.tree.map(put, self.scene)
        self.opt_state = AdamState(
            m=jax.tree.map(put, self.opt_state.m),
            v=jax.tree.map(put, self.opt_state.v),
            iteration=jax.device_put(self.opt_state.iteration, sh_r))

    @functools.cached_property
    def _indexed_gs_step(self):
        from webdgs.parallel.sharding import gs_train_step

        @functools.partial(
            jax.jit, donate_argnums=(1,),
            static_argnames=("img_w", "img_h", "entry_cap", "send_cap"))
        def run(scene, opt_state, cams, imgs, idx, img_w, img_h, entry_cap,
                send_cap):
            camera = jax.tree.map(lambda x: x[idx], cams)
            return gs_train_step(
                scene, opt_state, camera, imgs[idx], self.gs_mesh,
                img_w=img_w, img_h=img_h, loss_cfg=self.config.loss,
                hp=self.config.adam, settings=self.settings,
                send_capacity=send_cap, entry_capacity=entry_cap,
                parity_sh=not self.config.adam.full_sh)
        return run

    def step(self) -> dict:
        import time
        t0 = time.perf_counter()
        (w, h), g = self._pick_group()
        # numpy, not jnp: a jnp constructor is an eager per-step device op
        if self.n_step_views > 1:
            idx = np.asarray(
                [self.rng.randrange(g["count"])
                 for _ in range(self.n_step_views)], dtype=np.int32)
        else:
            idx = np.int32(self.rng.randrange(g["count"]))
        self.scene, self.opt_state, metrics = self._indexed_gs_step(
            self.scene, self.opt_state, g["cams"], g["imgs"], idx, w, h,
            self._gs_entry_cap, self._gs_send_cap)
        self.iteration += 1
        self._maybe_adapt_gs_caps(metrics)

        if self.config.densify.schedule.should_densify(self.iteration):
            self._run_densify(w, h)

        self._finish_step(t0, metrics)
        return metrics

    def _maybe_adapt_gs_caps(self, metrics) -> None:
        """Adapt the per-device entry capacity and the per-band send budget
        from the observed loads (one readback per interval, like the
        single-device entry cap)."""
        if self.iteration != 1 and self.iteration % self.ENTRY_CAP_INTERVAL:
            return
        chunk = self.settings.chunk
        e_obs = float(metrics["entries_local_max"])
        s_obs = float(metrics["send_max"])
        self._entry_cap_peak = max(e_obs,
                                   self.ENTRY_CAP_DECAY * self._entry_cap_peak)
        self._send_peak = max(s_obs, self.ENTRY_CAP_DECAY * self._send_peak)

        want_e = quantize_budget(
            self._entry_cap_peak * self.ENTRY_CAP_HEADROOM, chunk, chunk * 8)
        cur = self._gs_entry_cap
        if cur is None or want_e > cur or want_e < cur // 2:
            self._gs_entry_cap = want_e

        want_s = quantize_budget(
            self._send_peak * self.ENTRY_CAP_HEADROOM, chunk, chunk)
        cur = self._gs_send_cap
        if cur is None or want_s > cur or want_s < cur // 2:
            self._gs_send_cap = want_s

    @functools.cached_property
    def _gs_densify_fn(self):
        cfg = self.config.densify

        @functools.partial(jax.jit, static_argnames=("mw", "mh"))
        def run(scene, opt_state, cams, targets, view_idx, key, mw, mh):
            return gs_densify_event(
                scene, opt_state, cams, targets, view_idx, key,
                self.gs_mesh, mw=mw, mh=mh, cfg=cfg, settings=self.settings)
        return run

    def _on_state_resize(self) -> None:
        self._place()

    def _run_densify(self, w: int, h: int) -> None:
        cfg = self.config.densify
        g = self.groups[(w, h)]
        downscale = max(1, int(cfg.metric_downscale))
        mw, mh = max(1, w // downscale), max(1, h // downscale)

        # capacity growth first (mesh-divisible via self._round)
        self._grow_capacity()

        # spread alive rows + free slots evenly over the shards so the
        # event's local slot cap only binds when the global budget does
        self.scene, self.opt_state = rebalance_shards(
            self.scene, self.opt_state, self.d_band)
        self._place()

        n_views = min(max(1, cfg.metric_views), g["count"])
        view_idx = jnp.asarray(
            self.rng.sample(range(g["count"]), k=n_views), dtype=jnp.int32)
        self.key, sub = jax.random.split(self.key)
        cams_m = self._metric_camera(g["cams"], mw, mh)
        result = self._gs_densify_fn(self.scene, self.opt_state, cams_m,
                                     g["imgs"], view_idx, sub, mw, mh)

        # the single host readback per event (trainer.ts:447-457)
        out_total = int(result.out_total)
        in_alive = int(result.in_alive)
        if out_total == 0 or out_total == in_alive:
            return
        self.scene = result.scene
        self.opt_state = result.opt_state
        self.num_points = out_total
        self.last_densify_iteration = self.iteration
        self._grow_entry_cap_for_swap(out_total, in_alive)

    def _grow_entry_cap_for_swap(self, out_total: int, in_alive: int) -> None:
        """Sharded analogue of the base Trainer hook: a densify swap scales
        both the per-device entry load and the exchange send load ~linearly
        with the alive count, so both budgets grow with the swap instead of
        dropping entries until the next adaptation readback."""
        if not (out_total > in_alive > 0):
            return
        ratio = out_total / in_alive
        chunk = self.settings.chunk
        self._entry_cap_peak *= ratio
        self._send_peak *= ratio
        want_e = quantize_budget(
            self._entry_cap_peak * self.ENTRY_CAP_HEADROOM, chunk, chunk * 8)
        if self._gs_entry_cap is None or want_e > self._gs_entry_cap:
            self._gs_entry_cap = want_e
        want_s = quantize_budget(
            self._send_peak * self.ENTRY_CAP_HEADROOM, chunk, chunk)
        if self._gs_send_cap is None or want_s > self._gs_send_cap:
            self._gs_send_cap = want_s

    def resume_from(self, scene, opt_state, iteration: int) -> None:
        super().resume_from(scene, opt_state, iteration)
        self._place()

    def _rollback(self) -> None:
        # the host-side optimizer snapshot needs re-sharding over the band
        # axis before the next donated step
        super()._rollback()
        self._place()
