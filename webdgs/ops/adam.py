"""Per-group Adam with visibility gating — the reference's optimizer.

Reproduces src/shaders/adam.wgsl exactly in its default ("parity") mode:

* classic Adam WITHOUT bias correction (adam.wgsl:53-65; SURVEY.md Q3),
  no learning-rate schedule;
* per-group learning rates (defaults in src/renderers/adam-config.ts:12-21);
* visibility gating: a Gaussian whose ``tile_counts`` is zero is skipped
  entirely — parameters AND moments stay frozen (adam.wgsl:74-76);
* the quaternion is re-normalized after its update (adam.wgsl:124-126);
* SH: only the DC coefficient (3 of 48 floats) is trained, with lr_color
  applied to the raw dL/dcolor — the reference omits the SH_C0 basis factor
  (adam.wgsl:160-174; SURVEY.md Q2) — and f_rest stays frozen.

Improvement toggles (off by default for parity): ``bias_correction`` and
``full_sh`` (train all SH coefficients from true autodiff gradients, the
rest bands scaled by ``sh_rest_lr_scale`` as in canonical 3DGS).

**Packed (N, 59) state layout**: the reference runs one 256-wide pass over
a flat parameter buffer (adam.wgsl:40-174).  The analogue here is one fused
elementwise pass over ``(N, 59)`` rows instead of one pass per leaf.
Moments are STORED
packed; parameters are packed/unpacked at the step boundary (XLA fuses the
concatenate/slice into the update)."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class AdamHyperparameters:
    """Defaults: src/renderers/adam-config.ts:12-21."""

    lr_pos: float = 0.00016
    lr_color: float = 0.0025
    lr_opacity: float = 0.05
    lr_scale: float = 0.005
    lr_rot: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    bias_correction: bool = False
    full_sh: bool = False
    sh_rest_lr_scale: float = 0.05
    # optional canonical-3DGS exponential position-lr decay (the reference
    # has no schedule at all, SURVEY.md Q3); 0 disables
    lr_pos_final: float = 0.0
    lr_pos_decay_steps: int = 30_000

    def group_lrs(self) -> dict[str, float]:
        return {
            "means": self.lr_pos,
            "quats": self.lr_rot,
            "log_scales": self.lr_scale,
            "opacity_logits": self.lr_opacity,
            "sh": self.lr_color,
        }


# name -> (lane_lo, lane_hi, per-point shape suffix); row-major in the
# parameter order the reference's flat buffer uses implicitly
PACK_LAYOUT = (
    ("means", 0, 3, (3,)),
    ("quats", 3, 7, (4,)),
    ("log_scales", 7, 10, (3,)),
    ("opacity_logits", 10, 11, ()),
    ("sh", 11, 59, (16, 3)),
)
PACK_DIM = 59
_QUAT_LANES = (3, 7)
_OPACITY_LANE = 10
_SH_LANES = (11, 59)
_SH_DC_LANES = (11, 14)


def pack_rows(tree: dict[str, jax.Array]) -> jax.Array:
    """Parameter dict -> one (N, 59) row-packed array."""
    n = tree["means"].shape[0]
    return jnp.concatenate(
        [tree[k].reshape(n, hi - lo) for k, lo, hi, _ in PACK_LAYOUT],
        axis=1)


def unpack_rows(arr: jax.Array) -> dict[str, jax.Array]:
    """(N, 59) row-packed array -> parameter dict."""
    n = arr.shape[0]
    return {k: arr[:, lo:hi].reshape((n,) + suffix)
            for k, lo, hi, suffix in PACK_LAYOUT}


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["m", "v", "iteration"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class AdamState:
    m: jax.Array  # (N, 59) f32, rows in PACK_LAYOUT order
    v: jax.Array  # (N, 59) f32
    iteration: jax.Array  # () i32

    def replace(self, **updates) -> "AdamState":
        return dataclasses.replace(self, **updates)


def init_adam_state(params: dict[str, jax.Array]) -> AdamState:
    n = params["means"].shape[0]
    # m and v must be DISTINCT buffers: the step jits donate opt_state, and
    # donating the same buffer twice is an XLA error (f(donate(a), donate(a)))
    return AdamState(m=jnp.zeros((n, PACK_DIM), jnp.float32),
                     v=jnp.zeros((n, PACK_DIM), jnp.float32),
                     iteration=jnp.int32(0))


def _lane_lrs(hp: AdamHyperparameters) -> np.ndarray:
    """Static per-lane learning rates (lr_pos may be overridden by a traced
    schedule value on lanes 0:3)."""
    lr = np.zeros((PACK_DIM,), np.float32)
    lrs = hp.group_lrs()
    for key, lo, hi, _ in PACK_LAYOUT:
        lr[lo:hi] = lrs[key]
    if hp.full_sh:
        lr[_SH_DC_LANES[1]:_SH_LANES[1]] *= hp.sh_rest_lr_scale
    else:
        # parity: DC only (adam.wgsl:160-174); f_rest frozen
        lr[_SH_DC_LANES[1]:_SH_LANES[1]] = 0.0
    return lr


def adam_step(
    params: dict[str, jax.Array],
    grads: dict[str, jax.Array],
    state: AdamState,
    hp: AdamHyperparameters,
    tile_counts: jax.Array,  # (N,) i32 — 0 means invisible this step
) -> tuple[dict[str, jax.Array], AdamState]:
    visible = tile_counts > 0  # (N,)
    it = state.iteration + 1

    lane = np.arange(PACK_DIM)
    lr_vec = jnp.asarray(_lane_lrs(hp))[None, :]  # (1, 59)
    if hp.lr_pos_final > 0.0:
        frac = jnp.clip(it.astype(jnp.float32) / hp.lr_pos_decay_steps,
                        0.0, 1.0)
        lr_pos = hp.lr_pos * (hp.lr_pos_final / hp.lr_pos) ** frac
        lr_vec = jnp.where(jnp.asarray(lane < 3)[None, :], lr_pos, lr_vec)

    if hp.bias_correction:
        t = it.astype(jnp.float32)
        corr1 = 1.0 - hp.beta1 ** t
        corr2 = 1.0 - hp.beta2 ** t
    else:
        corr1 = corr2 = 1.0

    p = pack_rows(params)
    g = pack_rows(grads)
    if not hp.full_sh:
        # parity: non-DC SH gradients never touch the moments either
        g = g * jnp.asarray(
            (lane < _SH_DC_LANES[1]) | (lane >= _SH_LANES[1]),
            jnp.float32)[None, :]
    m, v = state.m, state.v

    mask = visible[:, None]
    m_new = hp.beta1 * m + (1.0 - hp.beta1) * g
    v_new = hp.beta2 * v + (1.0 - hp.beta2) * g * g
    step = -lr_vec * (m_new / corr1) / (jnp.sqrt(v_new / corr2) + hp.epsilon)
    p_new = p + step

    # quaternion renorm (adam.wgsl:124-126), lanes 3:7 only
    q_lane = jnp.asarray((lane >= _QUAT_LANES[0])
                         & (lane < _QUAT_LANES[1]))[None, :]
    qn = jnp.sqrt(jnp.maximum(
        jnp.sum(jnp.where(q_lane, p_new * p_new, 0.0), axis=1,
                keepdims=True), 1e-24))
    p_new = p_new * jnp.where(q_lane, 1.0 / qn, 1.0)

    new_params = unpack_rows(jnp.where(mask, p_new, p))
    return new_params, AdamState(m=jnp.where(mask, m_new, m),
                                 v=jnp.where(mask, v_new, v),
                                 iteration=it)
