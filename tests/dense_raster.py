"""Dense, fully differentiable JAX reference compositor.

Computes the same math as the rasterizer (webdgs/ops/rasterize.py)
with plain jnp ops over per-tile dense (P, K) arrays, so that JAX autodiff
of THIS function provides an independent oracle for the hand-written
backward pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from webdgs.config import RenderSettings
from webdgs.ops import rasterize as R


def composite_tile(attrs_t, t_idx, ntx, settings: RenderSettings):
    """attrs_t: (NUM_ROWS, K) entries of one tile in depth order."""
    p = settings.tile_px
    tx = t_idx % ntx
    ty = t_idx // ntx
    pix = jnp.arange(p)
    pxf = (tx * settings.tile_w + pix % settings.tile_w)[:, None] + 0.5
    pyf = (ty * settings.tile_h + pix // settings.tile_w)[:, None] + 0.5

    cx, cy = attrs_t[R.ROW_CX][None, :], attrs_t[R.ROW_CY][None, :]
    ca, cb, cc = (attrs_t[R.ROW_CA][None, :], attrs_t[R.ROW_CB][None, :],
                  attrs_t[R.ROW_CC][None, :])
    col = attrs_t[R.ROW_R:R.ROW_B + 1]  # (3, K)
    op = attrs_t[R.ROW_OP][None, :]
    ex, ey = attrs_t[R.ROW_EX][None, :], attrs_t[R.ROW_EY][None, :]

    dx = pxf - cx
    dy = pyf - cy
    power = ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy
    g = jnp.exp(-0.5 * power)
    alpha = jnp.minimum(op * g, settings.alpha_max)
    keep = (jnp.abs(dx) <= ex) & (jnp.abs(dy) <= ey) & \
        (alpha >= settings.alpha_min)
    alpha = jnp.where(keep, alpha, 0.0)

    alog = jnp.log1p(-alpha)
    log_t_excl = jnp.cumsum(alog, axis=1) - alog  # exclusive prefix
    t_excl = jnp.exp(log_t_excl)
    incl = jax.lax.stop_gradient(
        (t_excl >= settings.t_threshold).astype(jnp.float32))
    w = alpha * t_excl * incl

    c4 = jnp.concatenate([col, jnp.ones((1, col.shape[1]))], axis=0)
    acc = w @ c4.T  # (P, 4)
    t_gated = jnp.exp(jnp.sum(alog * incl, axis=1, keepdims=True))

    k = alpha.shape[1]
    pos = jnp.arange(1, k + 1, dtype=jnp.float32)[None, :]
    contrib = (alpha > 0) & (incl > 0)
    ncontrib = jnp.max(jnp.where(contrib, pos, 0.0), axis=1, keepdims=True)
    ncontrib = jax.lax.stop_gradient(ncontrib)

    # channel-planar (NUM_OUT, P), matching the rasterizer's layout
    return jnp.concatenate([acc, t_gated, ncontrib], axis=1).T


def rasterize_dense(attrs16, tile_offsets_np, ntx, nty,
                    settings: RenderSettings):
    """Differentiable full-frame compositor.  tile_offsets must be concrete
    (numpy) so per-tile slices are static."""
    with jax.default_matmul_precision("highest"):
        return _rasterize_dense(attrs16, tile_offsets_np, ntx, nty, settings)


def _rasterize_dense(attrs16, tile_offsets_np, ntx, nty,
                     settings: RenderSettings):
    outs = []
    offs = np.asarray(tile_offsets_np)
    for t in range(ntx * nty):
        lo, hi = int(offs[t]), int(offs[t + 1])
        if hi > lo:
            outs.append(composite_tile(attrs16[:, lo:hi], t, ntx, settings))
        else:
            p = settings.tile_px
            empty = jnp.zeros((R.NUM_OUT, p))
            empty = empty.at[R.OUT_T, :].set(1.0)
            outs.append(empty)
    return jnp.stack(outs, axis=0)  # (T, NUM_OUT, P)
