"""Tiled alpha-compositing rasterizer: Pallas-Triton forward/backward
kernels for the GPU, and a plain-``lax`` twin with the same maths.

This replaces the reference's per-pixel sequential loops
(src/shaders/tiled-rasterizer.wgsl:82-273 forward,
src/shaders/tiled-backward-rasterize.wgsl:34-172 backward) with a dense
formulation over (pixel, splat) blocks.

Key identity — *saturation as thresholding*: the reference skips a splat for
a pixel once accumulated alpha exceeds 0.99 (tiled-rasterizer.wgsl:224),
i.e. once transmittance T < 0.01.  Because T is monotonically
non-increasing along the depth-sorted splat list, the sequentially-gated
loop is exactly equivalent to

    T_j   = prod_{k<j} (1 - a_k)          (ungated, exclusive)
    incl_j = [T_j >= 0.01]                 (a prefix property)
    C      = sum_j c_j * a_j * T_j * incl_j

so compositing becomes a *cumulative sum of log(1-a) along the splat axis*
plus elementwise math — fully parallel over (pixel, splat) pairs.

The backward pass needs no back-to-front replay (the reference recovers T by
division and reconstructs a running suffix, tiled-backward-rasterize.wgsl:
121-141): with suffix_j = total - inclusive-prefix_j,

    dL/da_j = gamma_j * T_j - (U_tot - U_prefix_j + g_T * T_final) / (1-a_j)

where gamma_j = sum_ch g_ch c_{j,ch} and U = gamma * w accumulates forward.

GPU design: one program per tile; the tile's pixels are the rows of a
(P, K) block and one chunk of K depth-sorted entries its columns.  A
``while_loop`` walks the tile's chunks and stops once every pixel has
saturated.  The exclusive transmittance prefix within a chunk is an f32
``cumsum`` of log(1-a), and the colour accumulation a multiply-and-reduce
over the chunk axis, so the (pixel, splat) intermediates stay in registers.
The backward kernel stores per-entry gradients only into its own tile's
slots ``[uo, uo + cnt)``: tiles own disjoint slots, so programs, which run
in no order, never race.  Per-Gaussian accumulation happens outside the
kernels (:func:`pack_entry_attrs`).

The plain twin (:func:`rasterize_tiles_plain`) runs the same chunk maths
vmapped over tiles in one ``while_loop`` over the chunk index; it is the
reference the kernels are checked against at real widths.

Alpha semantics (kept consistent between forward and backward, unlike the
reference whose forward accumulates alphas below 1/255 that its backward
then skips):
  * alpha = min(0.99, opacity * exp(-0.5 * conic quad form))
            (tiled-rasterizer.wgsl:228-233)
  * pixels outside the splat's SnugBox extents are skipped
    (tiled-rasterizer.wgsl:208)
  * alpha < 1/255 contributes nothing (tiled-backward-rasterize.wgsl:116)
  * n_contrib = 1-based index of the last contributing splat in the tile
    (tiled-rasterizer.wgsl:238-240)
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from webdgs.config import RenderSettings, use_interpret_mode

# attribute-row layout of the packed per-entry splat array (NUM_ROWS, E)
ROW_CX, ROW_CY = 0, 1
ROW_CA, ROW_CB, ROW_CC = 2, 3, 4
ROW_R, ROW_G, ROW_B = 5, 6, 7
ROW_OP = 8
ROW_EX, ROW_EY = 9, 10
NUM_ROWS = 11
# rows with a nonzero gradient (the extents only gate pixels)
NUM_GRAD_ROWS = ROW_OP + 1

# output-channel layout of the per-tile pixel buffer (T, NUM_OUT, P),
# channel-planar: each channel of a tile is one contiguous P-pixel row
OUT_R, OUT_G, OUT_B = 0, 1, 2
OUT_ACC_ALPHA = 3
OUT_T = 4
OUT_NCONTRIB = 5
NUM_OUT = 6
# backward pixel-cotangent channels: d(r,g,b,acc) + the pixel's
# precomputed suffix term (see _make_rasterizer)
GPIX_SUFFIX = 4
NUM_GPIX = 5

# warps per tile program, per kernel (see PERF.md for the sweep)
FWD_WARPS = 8
BWD_WARPS = 8


def _pixel_coords(t, ntx, settings: RenderSettings):
    """Pixel-center coordinates of tile t as (P, 1) columns."""
    p = settings.tile_px
    pix = jax.lax.broadcasted_iota(jnp.int32, (p, 1), 0)
    pxf = ((t % ntx) * settings.tile_w
           + pix % settings.tile_w).astype(jnp.float32) + 0.5
    pyf = ((t // ntx) * settings.tile_h
           + pix // settings.tile_w).astype(jnp.float32) + 0.5
    return pxf, pyf


def chunk_alpha(rows, valid, pxf, pyf, settings: RenderSettings):
    """Per-(pixel, splat) alpha for one chunk.

    ``rows``: NUM_ROWS attribute rows, each (1, K); ``valid``: (1, K) lane
    validity (invalid lanes get alpha 0 — an exact no-op in the compositor
    and a zero in every gradient); ``pxf``/``pyf``: (P, 1) pixel centers.
    Returns (alpha, gaussian weight G, dx, dy), each (P, K).
    """
    dx = pxf - rows[ROW_CX]
    dy = pyf - rows[ROW_CY]
    ca, cb, cc = rows[ROW_CA], rows[ROW_CB], rows[ROW_CC]
    power = dx * (ca * dx + cb * dy) + dy * (cb * dx + cc * dy)
    g = jnp.exp(-0.5 * power)
    alpha = jnp.minimum(rows[ROW_OP] * g, settings.alpha_max)
    keep = ((jnp.abs(dx) <= rows[ROW_EX]) & (jnp.abs(dy) <= rows[ROW_EY])
            & (alpha >= settings.alpha_min) & valid)
    return jnp.where(keep, alpha, 0.0), g, dx, dy


def _transmittance(alpha, log_t, settings: RenderSettings):
    """Exclusive transmittance of each (pixel, splat) pair and its
    saturation gate: log_t (P, 1) is the ungated log-transmittance before
    the chunk."""
    alog = jnp.log1p(-alpha)
    t_excl = jnp.exp(jnp.cumsum(alog, axis=1) - alog + log_t)
    return alog, t_excl, t_excl >= settings.t_threshold


def _fwd_chunk(state, rows, valid, pos, pxf, pyf, settings: RenderSettings,
               track_ncontrib: bool):
    """Composite one chunk into the tile state: (log_t, r, g, b, acc,
    log_t_gated, n_contrib), each a (P, 1) column.  ``pos``: (1, K)
    1-based positions of the chunk's lanes within the tile."""
    log_t, acc_r, acc_g, acc_b, acc_a, log_tg, nmax = state
    alpha, _, _, _ = chunk_alpha(rows, valid, pxf, pyf, settings)
    alog, t_excl, incl = _transmittance(alpha, log_t, settings)
    w = jnp.where(incl, alpha * t_excl, 0.0)

    def acc(x):
        return jnp.sum(x, axis=1, keepdims=True)

    acc_r = acc_r + acc(w * rows[ROW_R])
    acc_g = acc_g + acc(w * rows[ROW_G])
    acc_b = acc_b + acc(w * rows[ROW_B])
    acc_a = acc_a + acc(w)
    log_tg = log_tg + acc(jnp.where(incl, alog, 0.0))
    if track_ncontrib:
        contrib = (alpha > 0.0) & incl
        nmax = jnp.maximum(nmax, jnp.max(jnp.where(contrib, pos, 0.0),
                                         axis=1, keepdims=True))
    return (log_t + acc(alog), acc_r, acc_g, acc_b, acc_a, log_tg, nmax)


def _bwd_chunk(state, rows, valid, pxf, pyf, gpix, settings: RenderSettings):
    """Per-entry gradients of one chunk.  ``state``: (log_t, cum_u) (P, 1)
    columns; ``gpix``: the (P, 1) cotangent columns (g_r, g_g, g_b, g_acc,
    suffix).  Returns (state, grads): NUM_GRAD_ROWS (1, K) gradient rows
    in ROW_* order."""
    log_t, cum_u = state
    g_r, g_g, g_b, g_a, suffix = gpix
    alpha, g, dx, dy = chunk_alpha(rows, valid, pxf, pyf, settings)
    alog, t_excl, incl = _transmittance(alpha, log_t, settings)
    w = jnp.where(incl, alpha * t_excl, 0.0)
    live = incl & (alpha > 0.0)

    gamma = (g_r * rows[ROW_R] + g_g * rows[ROW_G] + g_b * rows[ROW_B]
             + g_a)  # (P, K): d loss / d (colour, alpha) row of c4
    u = gamma * w
    u_prefix = cum_u + jnp.cumsum(u, axis=1)  # inclusive
    dl_da = jnp.where(live, gamma * t_excl
                      - (suffix - u_prefix) / (1.0 - alpha), 0.0)

    op = rows[ROW_OP]
    unclamped = op * g < settings.alpha_max
    def psum(x):
        return jnp.sum(x, axis=0, keepdims=True)

    d_op = psum(jnp.where(unclamped, dl_da * g, 0.0))
    # d power / d center = -2*(u1, u2) with u1 = ca dx + cb dy and
    # u2 = cb dx + cc dy, so the conic rows (per-splat constants) factor
    # out of the pixel sums
    q = jnp.where(unclamped, dl_da * op, 0.0) * (-0.5 * g)
    qx = q * dx
    qy = q * dy
    s_qx = psum(qx)
    s_qy = psum(qy)
    ca, cb, cc = rows[ROW_CA], rows[ROW_CB], rows[ROW_CC]
    grads = (
        -2.0 * (ca * s_qx + cb * s_qy),  # cx
        -2.0 * (cb * s_qx + cc * s_qy),  # cy
        psum(qx * dx),  # ca
        2.0 * psum(qx * dy),  # cb
        psum(qy * dy),  # cc
        psum(g_r * w),  # r
        psum(g_g * w),  # g
        psum(g_b * w),  # b
        d_op,
    )
    state = (log_t + jnp.sum(alog, axis=1, keepdims=True),
             cum_u + jnp.sum(u, axis=1, keepdims=True))
    return state, grads


def _saturated(log_t, settings: RenderSettings):
    """Every pixel of the tile ((P, 1) log-transmittance column) is below
    the early-termination threshold."""
    return jnp.max(log_t.reshape(-1)) < math.log(settings.t_threshold)


# ---------------------------------------------------------------------------
# Pallas-Triton kernels: one program per tile
# ---------------------------------------------------------------------------

def _tile_range(offsets_ref, t, k):
    uo = offsets_ref[t]
    cnt = offsets_ref[t + 1] - uo
    return uo, cnt, (cnt + k - 1) // k


def _load_rows(attrs_ref, start, valid, k):
    return [plgpu.load(attrs_ref.at[r, pl.ds(start, k)], mask=valid,
                       other=0.0)[None, :] for r in range(NUM_ROWS)]


def _fwd_kernel(offsets_ref, attrs_ref, out_ref, *, ntx: int,
                settings: RenderSettings, track_ncontrib: bool):
    k = settings.chunk
    t = pl.program_id(0)
    uo, cnt, nch = _tile_range(offsets_ref, t, k)
    pxf, pyf = _pixel_coords(t, ntx, settings)
    lane = jnp.arange(k, dtype=jnp.int32)

    def body(carry):
        c, state = carry
        local = c * k + lane
        valid = local < cnt
        rows = _load_rows(attrs_ref, uo + c * k, valid, k)
        pos = (local + 1).astype(jnp.float32)[None, :]
        return c + 1, _fwd_chunk(state, rows, valid[None, :], pos, pxf, pyf,
                                 settings, track_ncontrib)

    def cond(carry):
        c, state = carry
        return (c < nch) & ~_saturated(state[0], settings)

    zero = jnp.zeros((settings.tile_px, 1), jnp.float32)
    _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), (zero,) * 7))
    _, acc_r, acc_g, acc_b, acc_a, log_tg, nmax = state
    for ch, val in ((OUT_R, acc_r), (OUT_G, acc_g), (OUT_B, acc_b),
                    (OUT_ACC_ALPHA, acc_a), (OUT_T, jnp.exp(log_tg)),
                    (OUT_NCONTRIB, nmax)):
        out_ref[t, ch, :] = val.reshape(settings.tile_px)


def _bwd_kernel(offsets_ref, attrs_ref, gpix_ref, dout_ref, *, ntx: int,
                settings: RenderSettings):
    k = settings.chunk
    t = pl.program_id(0)
    uo, cnt, nch = _tile_range(offsets_ref, t, k)
    pxf, pyf = _pixel_coords(t, ntx, settings)
    gpix = [gpix_ref[t, ch, :][:, None] for ch in range(NUM_GPIX)]
    lane = jnp.arange(k, dtype=jnp.int32)
    zero_k = jnp.zeros((k,), jnp.float32)

    def body(carry):
        c, state = carry
        valid = c * k + lane < cnt
        start = uo + c * k
        rows = _load_rows(attrs_ref, start, valid, k)
        state, grads = _bwd_chunk(state, rows, valid[None, :], pxf, pyf,
                                  gpix, settings)
        for r, val in enumerate(grads):
            plgpu.store(dout_ref.at[r, pl.ds(start, k)], val.reshape(k),
                        mask=valid)
        for r in range(NUM_GRAD_ROWS, NUM_ROWS):
            plgpu.store(dout_ref.at[r, pl.ds(start, k)], zero_k, mask=valid)
        return c + 1, state

    def cond(carry):
        c, state = carry
        return (c < nch) & ~_saturated(state[0], settings)

    zero = jnp.zeros((settings.tile_px, 1), jnp.float32)
    done, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), (zero, zero)))

    # chunks skipped by the saturation exit hold entries that composite
    # nothing: their gradients are exact zeros
    def zero_fill(c, carry):
        valid = c * k + lane < cnt
        for r in range(NUM_ROWS):
            plgpu.store(dout_ref.at[r, pl.ds(uo + c * k, k)], zero_k,
                        mask=valid)
        return carry

    jax.lax.fori_loop(done, nch, zero_fill, done)


def _forward_kernel(attrs16, tile_offsets, ntx, nty,
                    settings: RenderSettings, track_ncontrib: bool):
    n_tiles = ntx * nty
    kernel = functools.partial(_fwd_kernel, ntx=ntx, settings=settings,
                               track_ncontrib=track_ncontrib)
    return pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        out_shape=jax.ShapeDtypeStruct((n_tiles, NUM_OUT, settings.tile_px),
                                       jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=FWD_WARPS,
                                             num_stages=1),
        interpret=use_interpret_mode(),
        name="raster_fwd",
    )(tile_offsets, attrs16)


def _backward_kernel(attrs16, tile_offsets, gpix, ntx, nty,
                     settings: RenderSettings):
    kernel = functools.partial(_bwd_kernel, ntx=ntx, settings=settings)
    return pl.pallas_call(
        kernel,
        grid=(ntx * nty,),
        out_shape=jax.ShapeDtypeStruct(attrs16.shape, jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=BWD_WARPS,
                                             num_stages=1),
        interpret=use_interpret_mode(),
        name="raster_bwd",
    )(tile_offsets, attrs16, gpix)


# ---------------------------------------------------------------------------
# plain-lax twin: all tiles vmapped, one loop over the chunk index
# ---------------------------------------------------------------------------

def _plain_chunks(attrs16, tile_offsets, ntx, nty, settings: RenderSettings):
    """Per-tile ranges, pixel coordinates and a chunk loader for the
    plain path.  The loader returns (rows (T, NUM_ROWS, K), valid (T, K),
    slot (T, K)) for chunk c of every tile."""
    k = settings.chunk
    e = attrs16.shape[1]
    uo = tile_offsets[:-1]
    cnt = tile_offsets[1:] - uo
    nch = (cnt + k - 1) // k
    t_ids = jnp.arange(ntx * nty, dtype=jnp.int32)
    pxf, pyf = jax.vmap(lambda t: _pixel_coords(t, ntx, settings))(t_ids)
    lane = jnp.arange(k, dtype=jnp.int32)

    def load(c):
        local = c * k + lane
        valid = local[None, :] < cnt[:, None]
        slot = uo[:, None] + local[None, :]
        rows = attrs16[:, jnp.clip(slot, 0, e - 1)]  # (R, T, K)
        return jnp.transpose(rows, (1, 0, 2)), valid, slot

    return nch, pxf, pyf, load


def _any_live(c, nch, log_t, settings: RenderSettings):
    """Some tile still has chunk c to composite and is not saturated."""
    saturated = jax.vmap(lambda x: _saturated(x, settings))(log_t)
    return jnp.any((c < nch) & ~saturated)


def _row_list(rows):
    return [rows[r][None, :] for r in range(NUM_ROWS)]


def _forward_plain(attrs16, tile_offsets, ntx, nty,
                   settings: RenderSettings, track_ncontrib: bool):
    k = settings.chunk
    nch, pxf, pyf, load = _plain_chunks(attrs16, tile_offsets, ntx, nty,
                                        settings)
    lane = jnp.arange(k, dtype=jnp.int32)

    def tile_chunk(state, rows, valid, pos, px, py):
        return _fwd_chunk(state, _row_list(rows), valid[None, :], pos, px,
                          py, settings, track_ncontrib)

    def body(carry):
        c, state = carry
        rows, valid, _ = load(c)
        pos = (c * k + lane + 1).astype(jnp.float32)[None, :]
        state = jax.vmap(tile_chunk, in_axes=(0, 0, 0, None, 0, 0))(
            state, rows, valid, pos, pxf, pyf)
        return c + 1, state

    def cond(carry):
        c, state = carry
        return _any_live(c, nch, state[0], settings)

    zero = jnp.zeros((ntx * nty, settings.tile_px, 1), jnp.float32)
    _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), (zero,) * 7))
    _, acc_r, acc_g, acc_b, acc_a, log_tg, nmax = state
    return jnp.concatenate([acc_r, acc_g, acc_b, acc_a, jnp.exp(log_tg),
                            nmax], axis=2).transpose(0, 2, 1)


def _backward_plain(attrs16, tile_offsets, gpix, ntx, nty,
                    settings: RenderSettings):
    nch, pxf, pyf, load = _plain_chunks(attrs16, tile_offsets, ntx, nty,
                                        settings)
    e = attrs16.shape[1]
    gcols = [gpix[:, ch, :, None] for ch in range(NUM_GPIX)]  # (T, P, 1)

    def tile_chunk(state, rows, valid, px, py, *g):
        return _bwd_chunk(state, _row_list(rows), valid[None, :], px, py, g,
                          settings)

    def body(carry):
        c, state, dout = carry
        rows, valid, slot = load(c)
        state, grads = jax.vmap(tile_chunk)(state, rows, valid, pxf, pyf,
                                            *gcols)
        # saturated chunks come out as exact zeros, like the kernel's fill
        grads = jnp.concatenate(grads, axis=1).transpose(1, 0, 2)
        dest = jnp.where(valid, slot, e)  # out of range: dropped
        dout = dout.at[:NUM_GRAD_ROWS, dest].set(grads, mode="drop",
                                                 unique_indices=True)
        return c + 1, state, dout

    def cond(carry):
        c, state, _ = carry
        return _any_live(c, nch, state[0], settings)

    zero = jnp.zeros((ntx * nty, settings.tile_px, 1), jnp.float32)
    _, _, dout = jax.lax.while_loop(
        cond, body, (jnp.int32(0), (zero, zero),
                     jnp.zeros((NUM_ROWS, e), jnp.float32)))
    return dout


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------

def _make_rasterizer(forward, backward, doc):
    @functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5))
    def raster(attrs16, tile_offsets, num_tiles_x, num_tiles_y,
               settings: RenderSettings, track_ncontrib: bool = True):
        return forward(attrs16, tile_offsets, num_tiles_x, num_tiles_y,
                       settings, track_ncontrib)

    def fwd(attrs16, tile_offsets, num_tiles_x, num_tiles_y, settings,
            track_ncontrib):
        out = forward(attrs16, tile_offsets, num_tiles_x, num_tiles_y,
                      settings, track_ncontrib)
        return out, (attrs16, tile_offsets, out)

    def bwd(num_tiles_x, num_tiles_y, settings, track_ncontrib, residuals,
            g):
        attrs16, tile_offsets, out = residuals
        # the forward outputs enter the backward maths only through the
        # per-pixel suffix term U_tot + g_T*T_final
        #   = sum_c g_c*out_c (c = r,g,b,acc) + g_T*T_final
        suffix = (jnp.sum(g[:, 0:4] * out[:, 0:4], axis=1, keepdims=True)
                  + g[:, OUT_T:OUT_T + 1] * out[:, OUT_T:OUT_T + 1])
        gpix = jnp.concatenate([g[:, 0:4], suffix], axis=1)  # (T, 5, P)
        d_attrs = backward(attrs16, tile_offsets, gpix, num_tiles_x,
                           num_tiles_y, settings)
        # slots outside every tile range are left unwritten by the kernel;
        # every consumer masks this cotangent by entry validity first
        d_offsets = np.zeros(tile_offsets.shape, dtype=jax.dtypes.float0)
        return d_attrs, d_offsets

    raster.defvjp(fwd, bwd)
    raster.__doc__ = doc
    return raster


_RASTER_DOC = """attrs16: (NUM_ROWS, E) packed per-entry splat attributes in
sorted tile/depth order; tile_offsets: (T+1,) i32 entry ranges (any
offsets: the kernels mask lanes past each tile's range).

``track_ncontrib``: the per-pixel last-contributor index (channel
OUT_NCONTRIB, tiled-rasterizer.wgsl:238-240) is consumed only by the
importance replay; training steps pass False and the forward skips its
bookkeeping (the channel reads 0).

Returns (T, NUM_OUT, P) channel-planar per-tile pixels
[r, g, b, acc_alpha, T_final, n_contrib] *without* background."""

rasterize_tiles = _make_rasterizer(_forward_kernel, _backward_kernel,
                                   _RASTER_DOC)
rasterize_tiles_plain = _make_rasterizer(
    _forward_plain, _backward_plain,
    _RASTER_DOC + "\n\nPlain-lax twin of :func:`rasterize_tiles` (the "
    "reference its kernels are checked against).")


def _pack_per_gauss(attrs):
    return jnp.concatenate([
        attrs.center_px,  # 2
        attrs.conic,  # 3
        attrs.color,  # 3
        attrs.opacity[:, None],  # 1
        attrs.extents,  # 2
    ], axis=1)  # (N, NUM_ROWS); column order must match ROW_* constants


def pack_entry_attrs(attrs, entry_gauss, entry_valid):
    """Gather per-Gaussian SplatAttrs into depth-sorted per-entry rows
    (NUM_ROWS, E).

    Invalid/padding entries are zeroed everywhere — opacity 0 makes them
    exact no-ops in the compositor, and the zero mask keeps their
    cotangents out of Gaussian 0's gradients.  The per-Gaussian gradient
    is the transpose of the gather: an XLA scatter-add, whose float sums
    run in no fixed order on the GPU.
    """
    per_gauss = _pack_per_gauss(attrs)
    return jnp.where(entry_valid[:, None], per_gauss[entry_gauss], 0.0).T


def composite_background(tiles, settings: RenderSettings):
    """accum + background * T_final (tiled-rasterizer.wgsl:250-252);
    tiles: (..., NUM_OUT) IMAGE-space pixel channels (channel-minor, i.e.
    after :func:`tiles_to_image`) -> (..., 3) final color."""
    bg = jnp.asarray(settings.background, dtype=jnp.float32)
    return tiles[..., 0:3] + bg * tiles[..., OUT_T:OUT_T + 1]


def tiles_to_image(out, num_tiles_x, num_tiles_y, img_w, img_h,
                   settings: RenderSettings):
    """(T, C, P) channel-planar per-tile pixels -> (H, W, C) image crop."""
    c = out.shape[1]
    img = out.reshape(num_tiles_y, num_tiles_x, c, settings.tile_h,
                      settings.tile_w)
    img = img.transpose(0, 3, 1, 4, 2).reshape(
        num_tiles_y * settings.tile_h, num_tiles_x * settings.tile_w, c)
    return img[:img_h, :img_w]


def image_to_tiles(img, num_tiles_x, num_tiles_y, settings: RenderSettings):
    """(H, W, C) -> channel-minor (T, P, C), zero-padding to the tile grid.
    Not the inverse layout of the rasterizer's planar (T, C, P) output."""
    h, w, c = img.shape
    ph = num_tiles_y * settings.tile_h - h
    pw = num_tiles_x * settings.tile_w - w
    img = jnp.pad(img, ((0, ph), (0, pw), (0, 0)))
    img = img.reshape(num_tiles_y, settings.tile_h, num_tiles_x,
                      settings.tile_w, c)
    return img.transpose(0, 2, 1, 3, 4).reshape(
        num_tiles_y * num_tiles_x, settings.tile_px, c)
