"""EWA projection: 3D Gaussians -> screen-space splats.

Re-implements the math of the reference's ``count_main`` kernel
(src/shaders/tiled-forward.wgsl:162-294) and its covariance helpers
(src/shaders/common.wgsl:44-108) as one fused, vectorized JAX function over
all N Gaussians.  It is fully differentiable — the reference's 304-line
hand-derived geometry backward (src/shaders/tiled-backward.wgsl) is replaced
by ``jax.vjp`` of this function.

Semantics preserved (file:line into /root/reference):
  * NDC cull at +-1.2 in xy and [0,1] in z      (tiled-forward.wgsl:198-201)
  * cov3D = R S^2 R^T from an *unnormalized* quaternion (common.wgsl:44-68 —
    the reference never normalizes in the forward path; Adam renormalizes
    after each update)
  * EWA cov2D with the 1.3*fov frustum clamp and +0.3 diagonal dilation
    (common.wgsl:71-108)
  * opacity-aware extent t = 2*ln(sigmoid(op)*128), SnugBox extents, screen
    radius cap (default 128 px)                  (tiled-forward.wgsl:222-234)
  * 2 px tile margin, viewport intersection, <=2048 tiles per Gaussian
    (tiled-forward.wgsl:238-277)
  * SH color from the normalized (mean - camera) direction, clamped to [0,1]
    on write                                     (tiled-forward.wgsl:258-285)

Known deviations (documented in ARCHITECTURE.md):
  * f32 throughout — the reference round-trips centers/extents through f16 so
    that its separate count/emit kernels agree (SURVEY.md Q4); we compute the
    tile range once, so no quantization is needed.
  * gradients come from autodiff, which fixes the reference's sign error in
    the y-component of the position gradient through the projection
    (tiled-backward.wgsl:92 multiplies dL/dpx by +0.5*viewport for both axes,
    but the forward y mapping is px_y = (-0.5*ndc_y + 0.5)*H).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from webdgs.config import RenderSettings
from webdgs.core.camera import Camera
from webdgs.ops.sh import eval_sh_color_rows

OPACITY_THRESHOLD = 128.0  # tiled-forward.wgsl:223
TILE_MARGIN_PX = 2.0  # tiled-forward.wgsl:238
NDC_CULL = 1.2  # tiled-forward.wgsl:198


class SplatAttrs(NamedTuple):
    """Differentiable per-Gaussian screen-space attributes."""

    center_px: jax.Array  # (N, 2)
    conic: jax.Array  # (N, 3) (a, b, c) of the inverse 2D covariance
    color: jax.Array  # (N, 3) in [0, 1]
    opacity: jax.Array  # (N,) sigmoid-space
    extents: jax.Array  # (N, 2) capped SnugBox half-extents in px


class SplatAux(NamedTuple):
    """Non-differentiable binning metadata."""

    depth: jax.Array  # (N,) view-space z
    visible: jax.Array  # (N,) bool
    tile_min: jax.Array  # (N, 2) i32 (tx_min, ty_min)
    tile_dims: jax.Array  # (N, 2) i32 (tiles_x, tiles_y)
    num_tiles: jax.Array  # (N,) i32, 0 when culled
    radius_capped: jax.Array  # (N,) bool — extent hit max_splat_radius_px


def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """(N,4) (w,x,y,z) -> (N,3,3); standard form, no normalization
    (common.wgsl:44-53 builds the transpose column-wise; the resulting
    covariance R S^2 R^T is this standard matrix)."""
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        jnp.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        jnp.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def _rotmat_rows(q: tuple[jax.Array, ...]):
    """Rotation matrix entries as nine (N,) rows from unnormalized quat rows
    (common.wgsl:44-53)."""
    r, x, y, z = q
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)),
        (2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)),
        (2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)),
    )


def _cov3d_rows(q, s2):
    """Unique entries of Sigma = R diag(s^2) R^T as six (N,) rows
    (common.wgsl:44-68).

    Row form: six (N,) vectors, no (N, 3, 3) intermediates."""
    m = _rotmat_rows(q)
    s0, s1, s2_ = s2

    def sig(i, j):
        return (m[i][0] * m[j][0] * s0 + m[i][1] * m[j][1] * s1
                + m[i][2] * m[j][2] * s2_)

    return sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)


def covariance3d(quats: jax.Array, scales: jax.Array) -> jax.Array:
    """Sigma = R diag(s^2) R^T, (N,3,3) (common.wgsl:44-68)."""
    rot = quat_to_rotmat(quats)
    return jnp.einsum("nij,nj,nkj->nik", rot, scales * scales, rot)


def project_gaussians(
    params: dict[str, jax.Array],
    alive: jax.Array,
    camera: Camera,
    img_w: int,
    img_h: int,
    sh_deg: int,
    settings: RenderSettings,
    detach_color: bool = False,
    gaussian_scaling: jax.Array | float | None = None,
) -> tuple[SplatAttrs, SplatAux]:
    """``gaussian_scaling``: optional TRACED override of
    ``settings.gaussian_scaling`` — the viewer sweeps the scale knob live,
    and a static (compile-time) value would recompile the whole render
    pipeline per step of the slider.  None uses the static setting.

    ``detach_color``: stop gradients through the SH color evaluation
    (both into the coefficients and into positions via the view direction).
    The reference's backward has no color->geometry path and its SH DC
    gradient is routed separately (tiled-backward.wgsl; SURVEY.md Q2), so
    parity training sets this and skips the whole SH backward.

    Design note: all geometry runs in "row form" — every per-Gaussian
    quantity is an (N,) vector, exactly like the WGSL scalar code but
    vectorized over N.  No tiny (N,3,3) einsums are formed, so no matmul
    precision setting can round the centers: row form is exact f32 by
    construction.
    """
    return _project_gaussians_impl(params, alive, camera, img_w, img_h,
                                   sh_deg, settings, detach_color,
                                   gaussian_scaling)


def _project_gaussians_impl(params, alive, camera, img_w, img_h, sh_deg,
                            settings, detach_color, gaussian_scaling=None):
    means = params["means"]
    quats = params["quats"]
    log_scales = params["log_scales"]
    opacity_logits = params["opacity_logits"]
    sh = params["sh"]

    view, proj = camera.view, camera.proj
    viewport = jnp.array([img_w, img_h], dtype=jnp.float32)
    focal_x, focal_y = camera.focal[0], camera.focal[1]

    mT = means.T  # (3, N): one relayout, then free (N,) row views
    m0, m1, m2 = mT[0], mT[1], mT[2]

    # --- view / clip transform (tiled-forward.wgsl:188-201) ---
    def vdot(row, c3):
        return row[0] * m0 + row[1] * m1 + row[2] * m2 + row[3] * c3

    one = jnp.float32(1.0)
    t0 = vdot(view[0], one)
    t1 = vdot(view[1], one)
    tz = vdot(view[2], one)

    def pdot(row):
        return row[0] * t0 + row[1] * t1 + row[2] * tz + row[3]

    clip0, clip1, clip2, w = pdot(proj[0]), pdot(proj[1]), pdot(proj[2]), \
        pdot(proj[3])
    w_ok = w != 0.0
    w_safe = jnp.where(w_ok, w, 1.0)
    ndc0 = clip0 / w_safe
    ndc1 = clip1 / w_safe
    ndc2 = clip2 / w_safe

    in_frustum = (
        (ndc0 >= -NDC_CULL) & (ndc0 <= NDC_CULL)
        & (ndc1 >= -NDC_CULL) & (ndc1 <= NDC_CULL)
        & (ndc2 >= 0.0) & (ndc2 <= 1.0)
        & w_ok & alive
    )

    # --- 3D covariance rows (common.wgsl:44-68) ---
    # gaussian_scaling: the reference's "Gaussian scale" slider writes this
    # settings field (tiled-forward-pass.ts:392-395) but no tiled-path
    # shader ever reads it; here the knob actually works, as a scale
    # multiplier on the decoded stddev
    lsT = log_scales.T
    gsc = (settings.gaussian_scaling if gaussian_scaling is None
           else gaussian_scaling)
    gs2 = gsc * gsc
    s2 = (gs2 * jnp.exp(2.0 * lsT[0]), gs2 * jnp.exp(2.0 * lsT[1]),
          gs2 * jnp.exp(2.0 * lsT[2]))
    qT = quats.T
    c00, c01, c02, c11, c12, c22 = _cov3d_rows(
        (qT[0], qT[1], qT[2], qT[3]), s2)

    # --- EWA 2D covariance (common.wgsl:71-108) ---
    tz_safe = jnp.where(in_frustum, tz, 1.0)
    lim_x = 1.3 * (viewport[0] * 0.5) / focal_x
    lim_y = 1.3 * (viewport[1] * 0.5) / focal_y
    tx = jnp.clip(t0 / tz_safe, -lim_x, lim_x) * tz_safe
    ty = jnp.clip(t1 / tz_safe, -lim_y, lim_y) * tz_safe

    inv_z = 1.0 / tz_safe
    # J (2x3 Jacobian of the perspective projection at the clamped point)
    # composed with W = view[:3,:3]: A = J @ W, two (N,) rows per column.
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z * inv_z
    a0 = (j00 * view[0, 0] + j02 * view[2, 0],
          j00 * view[0, 1] + j02 * view[2, 1],
          j00 * view[0, 2] + j02 * view[2, 2])
    a1 = (j11 * view[1, 0] + j12 * view[2, 0],
          j11 * view[1, 1] + j12 * view[2, 1],
          j11 * view[1, 2] + j12 * view[2, 2])

    def quad(u, v):
        """u^T Sigma v for symmetric Sigma rows."""
        return (c00 * u[0] * v[0] + c11 * u[1] * v[1] + c22 * u[2] * v[2]
                + c01 * (u[0] * v[1] + u[1] * v[0])
                + c02 * (u[0] * v[2] + u[2] * v[0])
                + c12 * (u[1] * v[2] + u[2] * v[1]))

    cov_a = quad(a0, a0) + 0.3
    cov_b = quad(a0, a1)
    cov_c = quad(a1, a1) + 0.3

    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det > 0.0
    det_safe = jnp.where(det_ok, det, 1.0)
    conic_a = cov_c / det_safe
    conic_b = -cov_b / det_safe
    conic_c = cov_a / det_safe
    disc = conic_b * conic_b - conic_a * conic_c
    ellipse_ok = (conic_a > 0.0) & (conic_c > 0.0) & (disc < 0.0)

    # --- opacity-aware extent (tiled-forward.wgsl:222-234) ---
    opacity = jax.nn.sigmoid(opacity_logits)
    t_pow = 2.0 * jnp.log(jnp.maximum(opacity * OPACITY_THRESHOLD, 1e-12))
    opacity_ok = t_pow > 0.0

    valid_so_far = in_frustum & det_ok & ellipse_ok & opacity_ok
    neg_disc = jnp.where(valid_so_far, -disc, 1.0)
    t_pos = jnp.where(valid_so_far, t_pow, 1.0)
    x_extent = jnp.sqrt(t_pos * jnp.where(valid_so_far, conic_c, 1.0) / neg_disc)
    y_extent = jnp.sqrt(t_pos * jnp.where(valid_so_far, conic_a, 1.0) / neg_disc)

    cap = settings.max_splat_radius_px if settings.max_splat_radius_px > 0 else 1e9
    radius_capped = jnp.maximum(x_extent, y_extent) >= cap
    x_extent_cap = jnp.minimum(x_extent, cap)
    y_extent_cap = jnp.minimum(y_extent, cap)

    # --- pixel center and tile range (tiled-forward.wgsl:236-277) ---
    cx = (ndc0 * 0.5 + 0.5) * viewport[0]
    cy = (ndc1 * -0.5 + 0.5) * viewport[1]

    ex_sg = jax.lax.stop_gradient(x_extent_cap)
    ey_sg = jax.lax.stop_gradient(y_extent_cap)
    cx_sg = jax.lax.stop_gradient(cx)
    cy_sg = jax.lax.stop_gradient(cy)
    bminx_raw = cx_sg - ex_sg - TILE_MARGIN_PX
    bminy_raw = cy_sg - ey_sg - TILE_MARGIN_PX
    bmaxx_raw = cx_sg + ex_sg + TILE_MARGIN_PX
    bmaxy_raw = cy_sg + ey_sg + TILE_MARGIN_PX
    on_screen = (
        (bmaxx_raw >= 0.0) & (bmaxy_raw >= 0.0)
        & (bminx_raw < viewport[0]) & (bminy_raw < viewport[1])
    )
    bminx = jnp.maximum(bminx_raw, 0.0)
    bminy = jnp.maximum(bminy_raw, 0.0)
    bmaxx = jnp.minimum(bmaxx_raw, viewport[0] - 1.0)
    bmaxy = jnp.minimum(bmaxy_raw, viewport[1] - 1.0)
    bbox_ok = (bmaxx >= bminx) & (bmaxy >= bminy)

    num_tiles_x = -(-img_w // settings.tile_w)
    num_tiles_y = -(-img_h // settings.tile_h)
    tile_min_x = bminx.astype(jnp.int32) // settings.tile_w
    tile_min_y = bminy.astype(jnp.int32) // settings.tile_h
    tile_max_x = jnp.minimum(bmaxx.astype(jnp.int32) // settings.tile_w,
                             num_tiles_x - 1)
    tile_max_y = jnp.minimum(bmaxy.astype(jnp.int32) // settings.tile_h,
                             num_tiles_y - 1)
    tiles_x = tile_max_x - tile_min_x + 1
    tiles_y = tile_max_y - tile_min_y + 1
    num_tiles = tiles_x * tiles_y
    tiles_ok = num_tiles <= settings.max_tiles_per_gaussian

    visible = valid_so_far & on_screen & bbox_ok & tiles_ok
    num_tiles = jnp.where(visible, num_tiles, 0)

    # --- SH color (tiled-forward.wgsl:258-261, clamp at :284-285) ---
    # Row form like the rest of the file: the (N, 16, 3) leaf is viewed as
    # planar (48, N) once, then the whole evaluation is fused (N,) FMAs —
    # no (N, k, 3) intermediates, no tiny batched dot.
    cam_pos = camera.cam_pos
    r0, r1, r2 = m0 - cam_pos[0], m1 - cam_pos[1], m2 - cam_pos[2]
    norm = jnp.sqrt(jnp.maximum(r0 * r0 + r1 * r1 + r2 * r2, 1e-24))
    dx, dy, dz = r0 / norm, r1 / norm, r2 / norm
    sh_planar = sh.reshape(sh.shape[0], 48).T
    if detach_color:
        sh_planar = jax.lax.stop_gradient(sh_planar)
        dx = jax.lax.stop_gradient(dx)
        dy = jax.lax.stop_gradient(dy)
        dz = jax.lax.stop_gradient(dz)
    col0, col1, col2 = eval_sh_color_rows(sh_planar, dx, dy, dz, sh_deg)
    color = jnp.stack([jnp.clip(col0, 0.0, 1.0), jnp.clip(col1, 0.0, 1.0),
                       jnp.clip(col2, 0.0, 1.0)], axis=-1)

    attrs = SplatAttrs(
        center_px=jnp.stack([cx, cy], axis=-1),
        conic=jnp.stack([conic_a, conic_b, conic_c], axis=-1),
        color=color,
        opacity=opacity,
        extents=jnp.stack([x_extent_cap, y_extent_cap], axis=-1),
    )
    aux = SplatAux(
        depth=jax.lax.stop_gradient(tz),
        visible=visible,
        tile_min=jnp.stack([tile_min_x, tile_min_y], axis=-1),
        tile_dims=jnp.stack([tiles_x, tiles_y], axis=-1),
        num_tiles=num_tiles,
        radius_capped=radius_capped & visible,
    )
    return attrs, aux


def restrict_aux_to_band(aux: SplatAux, row0, rows: int) -> SplatAux:
    """Clip each Gaussian's tile rect to tile rows [row0, row0+rows) and
    rebase tile ids to the band.

    Shared by the tile-sharded multi-device renderer (each device owns a
    band) and the single-device serial-band renderer (frames whose tile
    grid exceeds the 16-bit tile-key ceiling are rendered band by band).
    ``row0`` may be a traced scalar so one compile serves every band.
    """
    ty0 = aux.tile_min[:, 1]
    ty1 = ty0 + aux.tile_dims[:, 1] - 1
    ny0 = jnp.maximum(ty0, row0)
    ny1 = jnp.minimum(ty1, row0 + rows - 1)
    tiles_y = ny1 - ny0 + 1
    overlap = tiles_y > 0
    visible = aux.visible & overlap
    tiles_y = jnp.where(visible, tiles_y, 0)
    tile_min = jnp.stack([aux.tile_min[:, 0],
                          jnp.maximum(ny0 - row0, 0)], axis=-1)
    tile_dims = jnp.stack([aux.tile_dims[:, 0], tiles_y], axis=-1)
    num_tiles = jnp.where(visible, aux.tile_dims[:, 0] * tiles_y, 0)
    return SplatAux(depth=aux.depth, visible=visible, tile_min=tile_min,
                    tile_dims=tile_dims, num_tiles=num_tiles,
                    radius_capped=aux.radius_capped)
