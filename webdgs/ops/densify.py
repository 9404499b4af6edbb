"""Densify / prune: decide + compaction-with-expansion, fixed capacity.

The reference runs this as 4 decision/scan passes plus 6 scatter kernels
into freshly allocated GPU buffers, followed by a full render-graph rebuild
(src/renderers/densify-prune.ts:458-678, src/shaders/densify-prune-*.wgsl,
src/trainer.ts:373-497).  Under XLA we keep a capacity-padded scene with an
alive mask, so the whole event is one jitted function: a vectorized decide,
a cumsum, one ``repeat`` expansion, and masked gathers per parameter leaf —
no reallocation, no pipeline rebuild.

Decision rules (densify-prune-decide.wgsl:73-88):
  * prune  (count 0) if sigmoid(opacity) < prune_opacity
  * split  (count 2) if importance >= clone_threshold_count and
           max 3D scale >= split_scale_threshold
  * clone  (count 2) if importance >= clone_threshold_count otherwise
  * keep   (count 1) else

Transform rules (densify-prune-scatter-gaussians.wgsl):
  * every surviving point clamps opacity to sigmoid <= 0.8
    (raw logit 1.38629436112) (:27-28,84-86)
  * clone slot 1 jitters position by quat-rotated 0.25*sigma*U(-1,1)^3
    (:111-121)
  * split emits two children at +-quat-rotated 0.5*sigma*N(0,1)^3 (the same
    draw for both slots) and divides scale by 1.6 (:67-77,124-137); sigma
    uses the +-10-clamped log-scale (:49-52)
  * Adam moments reset for new slots (clone slot 1, both split slots);
    the opacity moments reset for EVERY surviving point — a reference quirk
    we preserve (densify-prune-scatter-opt-float.wgsl:29-36)

Capacity is enforced like the reference's cap pass
(densify-prune-cap.wgsl): output clipped to
min(static capacity, alive + max_new_points_per_step), degrading
clone/split to keep at the boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from webdgs.core.scene import GaussianScene
from webdgs.ops.adam import _OPACITY_LANE, PACK_DIM, AdamState
from webdgs.train.config import DensifyPruneConfig

OPACITY_MAX = 0.8
OPACITY_MAX_RAW = 1.38629436112  # logit(0.8) (scatter-gaussians.wgsl:28)
LN_1P6 = 0.4700036292457356  # ln(1.6) (scatter-gaussians.wgsl:26)

ACTION_KEEP, ACTION_CLONE, ACTION_SPLIT, ACTION_PRUNE = 0, 1, 2, 3


class DensifyResult(NamedTuple):
    scene: GaussianScene
    opt_state: AdamState
    out_total: jax.Array  # () i32 — points after the event
    in_alive: jax.Array  # () i32 — points before the event
    n_cloned: jax.Array
    n_split: jax.Array
    n_pruned: jax.Array


def decide(scene: GaussianScene, metric_counts: jax.Array,
           cfg: DensifyPruneConfig):
    """(counts, actions) per slot (densify-prune-decide.wgsl:73-88)."""
    opacity = jax.nn.sigmoid(scene.opacity_logits)
    max_scale = jnp.max(jnp.exp(scene.log_scales), axis=-1)

    prune = opacity < cfg.prune_opacity
    densify = metric_counts >= cfg.clone_threshold_count
    split = densify & (max_scale >= cfg.split_scale_threshold)

    action = jnp.where(prune, ACTION_PRUNE,
                       jnp.where(split, ACTION_SPLIT,
                                 jnp.where(densify, ACTION_CLONE,
                                           ACTION_KEEP)))
    count = jnp.where(prune, 0, jnp.where(densify, 2, 1))
    # dead slots contribute nothing
    action = jnp.where(scene.alive, action, ACTION_PRUNE)
    count = jnp.where(scene.alive, count, 0)
    return count.astype(jnp.int32), action.astype(jnp.int32)


def _quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate v by the (normalized) (w,x,y,z) quaternion
    (scatter-gaussians.wgsl:59-65)."""
    norm = jnp.sqrt(jnp.maximum(jnp.sum(q * q, axis=-1, keepdims=True),
                                1e-12))
    qn = q / norm
    s = qn[:, 0:1]
    u = qn[:, 1:4]
    udv = jnp.sum(u * v, axis=-1, keepdims=True)
    uu = jnp.sum(u * u, axis=-1, keepdims=True)
    return 2.0 * udv * u + (s * s - uu) * v + 2.0 * s * jnp.cross(u, v)


def cap_counts(counts: jax.Array, actions: jax.Array, max_out,
               base_offset=0):
    """Clip counts so outputs stay under ``max_out`` (densify-prune-cap.wgsl),
    degrading boundary clones/splits to keep.  ``base_offset`` shifts the
    output offsets (the sharded event passes each shard's global base so cap
    decisions match the single-device event exactly).

    Returns (counts, actions, total) — total is the local output count.
    Output offsets are NOT returned: they must come from a fresh cumsum of
    the CLIPPED counts (compact_transform recomputes them), never from the
    pre-clip prefix used for the cap decision."""
    offsets = jnp.cumsum(counts) - counts
    counts = jnp.clip(max_out - (offsets + base_offset), 0, counts)
    total = jnp.sum(counts)
    # a clone/split clipped from 2 to 1 at the boundary degrades to keep so
    # the surviving slot is an untransformed copy (densify-prune-cap.wgsl:
    # 45-48); without this a boundary split would emit one jittered,
    # scale-shrunk child instead of keeping the original
    degraded = (counts == 1) & ((actions == ACTION_CLONE)
                                | (actions == ACTION_SPLIT))
    actions = jnp.where(degraded, ACTION_KEEP, actions)
    return counts, actions, total


def compact_transform(params: dict, opt_state: AdamState, counts, actions,
                      total, jitter_u, split_d):
    """Compaction-with-expansion + the reference's 6 scatter transforms, for
    a (possibly shard-local) slice.  ``jitter_u``/``split_d``: per-SOURCE
    random rows (N, 3).  Output capacity equals the input capacity; slots
    >= ``total`` are dead.

    Returns (new_params, new_opt, valid_out)."""
    n = counts.shape[0]
    offsets = jnp.cumsum(counts) - counts

    # out slot -> (source gaussian, variant)
    src = jnp.repeat(jnp.arange(n, dtype=jnp.int32), counts,
                     total_repeat_length=n)
    o_idx = jnp.arange(n, dtype=jnp.int32)
    valid_out = o_idx < total
    src = jnp.where(valid_out, src, 0)
    variant = o_idx - offsets[src]
    act = actions[src]

    p_src = {k: v[src] for k, v in params.items()}

    # per-source randomness: U(-1,1)^3 for clone jitter, N(0,1)^3 for split
    jitter_u = jitter_u[src]
    split_d = split_d[src]

    log_sigma = jnp.clip(p_src["log_scales"], -10.0, 10.0)
    sigma = jnp.exp(log_sigma)
    quats = p_src["quats"]

    is_clone_child = (act == ACTION_CLONE) & (variant == 1)
    is_split = act == ACTION_SPLIT

    pos = p_src["means"]
    pos = jnp.where(is_clone_child[:, None],
                    pos + _quat_rotate(quats, 0.25 * sigma * jitter_u), pos)
    split_sign = jnp.where(variant == 1, -1.0, 1.0)[:, None]
    pos = jnp.where(is_split[:, None],
                    p_src["means"] + split_sign
                    * _quat_rotate(quats, 0.5 * sigma * split_d), pos)

    log_scales = jnp.where(is_split[:, None], log_sigma - LN_1P6,
                           p_src["log_scales"])

    op = p_src["opacity_logits"]
    op = jnp.where(jax.nn.sigmoid(op) > OPACITY_MAX, OPACITY_MAX_RAW, op)

    new_params = {
        "means": pos,
        "quats": quats,
        "log_scales": log_scales,
        "opacity_logits": op,
        "sh": p_src["sh"],
    }
    new_params = {k: jnp.where(
        valid_out.reshape((-1,) + (1,) * (v.ndim - 1)), v,
        jnp.zeros_like(v)) for k, v in new_params.items()}

    # Adam moments: one (N, 59) gather, reset for new slots; the opacity
    # lane always resets (reference quirk,
    # densify-prune-scatter-opt-float.wgsl:33-41)
    is_new = is_clone_child | is_split
    reset = (is_new | (~valid_out))[:, None]
    lane_keep = jnp.asarray(
        np.arange(PACK_DIM) != _OPACITY_LANE, jnp.float32)[None, :]

    def move_state(arr):
        return jnp.where(reset, 0.0, arr[src]) * lane_keep

    new_opt = AdamState(m=move_state(opt_state.m), v=move_state(opt_state.v),
                        iteration=opt_state.iteration)
    return new_params, new_opt, valid_out


def densify_rng(key: jax.Array, n: int):
    """The event's per-source random rows: U(-1,1)^3 clone jitter and
    N(0,1)^3 split direction (densify-prune-scatter-gaussians.wgsl:67-77,
    111-121).  Shared by the single-device and sharded events so a shard
    slicing rows [b*n_loc, (b+1)*n_loc) of the same key draws exactly the
    single-device values."""
    k1, k2 = jax.random.split(key)
    jitter_u = jax.random.uniform(k1, (n, 3), jnp.float32, -1.0, 1.0)
    split_d = jax.random.normal(k2, (n, 3), jnp.float32)
    return jitter_u, split_d


def densify_prune(scene: GaussianScene, opt_state: AdamState,
                  metric_counts: jax.Array, cfg: DensifyPruneConfig,
                  key: jax.Array) -> DensifyResult:
    n = scene.capacity
    counts, actions = decide(scene, metric_counts, cfg)
    in_alive = jnp.sum(scene.alive.astype(jnp.int32))

    # capacity cap (densify-prune-cap.wgsl; trainer.ts:147-160 growth cap)
    max_out = jnp.minimum(jnp.int32(n),
                          in_alive + jnp.int32(cfg.max_new_points_per_step))
    counts, actions, total = cap_counts(counts, actions, max_out)

    jitter_u, split_d = densify_rng(key, n)
    new_params, new_opt, valid_out = compact_transform(
        scene.params(), opt_state, counts, actions, total, jitter_u, split_d)
    new_scene = scene.with_params(new_params).replace(alive=valid_out)

    live_src = scene.alive
    return DensifyResult(
        scene=new_scene,
        opt_state=new_opt,
        out_total=total,
        in_alive=in_alive,
        n_cloned=jnp.sum((actions == ACTION_CLONE) & live_src),
        n_split=jnp.sum((actions == ACTION_SPLIT) & live_src),
        n_pruned=jnp.sum((actions == ACTION_PRUNE) & live_src),
    )
