"""Spherical-harmonics color evaluation.

Same basis and Condon-Shortley phases as the reference's
``computeColorFromSH`` (src/shaders/tiled-forward.wgsl:7-24,89-119).  Instead
of the reference's nested per-degree branches, we build the full 16-entry
basis vector and contract it against the coefficients with an einsum — one
fused op, with unused degrees masked by a static weight.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# number of coefficients for degrees 0..3
NUM_COEFFS = (1, 4, 9, 16)


def sh_basis(dirs: jnp.ndarray) -> jnp.ndarray:
    """Evaluate the 16 real SH basis functions at unit directions (N,3)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = jnp.ones_like(x)
    basis = [
        SH_C0 * one,
        -SH_C1 * y,
        SH_C1 * z,
        -SH_C1 * x,
        SH_C2[0] * xy,
        SH_C2[1] * yz,
        SH_C2[2] * (2.0 * zz - xx - yy),
        SH_C2[3] * xz,
        SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3.0 * xx - yy),
        SH_C3[1] * xy * z,
        SH_C3[2] * y * (4.0 * zz - xx - yy),
        SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        SH_C3[4] * x * (4.0 * zz - xx - yy),
        SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3.0 * yy),
    ]
    return jnp.stack(basis, axis=-1)  # (..., 16)


def eval_sh_color(sh: jnp.ndarray, dirs: jnp.ndarray, sh_deg: int) -> jnp.ndarray:
    """SH -> RGB, degree-gated; adds 0.5 and clamps at 0 from below
    (tiled-forward.wgsl:116-118).

    sh: (N, 16, 3); dirs: (N, 3) unit vectors; returns (N, 3).

    Kept as the dense-einsum oracle for tests; the projection hot path uses
    the row-form :func:`eval_sh_color_rows` (same math, same f32 sum order —
    sequential over k).
    """
    if not 0 <= sh_deg <= 3:
        raise ValueError(f"unsupported sh_deg {sh_deg}")
    k = NUM_COEFFS[sh_deg]
    basis = sh_basis(dirs)[..., :k]  # (N, k)
    # HIGHEST: this k<=16 contraction must stay f32-exact (the GPU's
    # default f32 matmul may run in TF32); the op is tiny so exactness is
    # free
    color = jnp.einsum("nk,nkc->nc", basis, sh[:, :k, :],
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(color + 0.5, 0.0)


def sh_basis_rows(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray, k: int):
    """The first ``k`` SH basis functions as a tuple of (N,) rows.

    Same polynomials as :func:`sh_basis` but never stacks: each basis value
    stays an (N,) vector, matching the row-form
    projection (projection.py design note)."""
    out = [SH_C0 * jnp.ones_like(x)]
    if k > 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            SH_C2[0] * (x * y),
            SH_C2[1] * (y * z),
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * (x * z),
            SH_C2[4] * (xx - yy),
        ]
    if k > 9:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * (x * y) * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return tuple(out[:k])


def eval_sh_color_rows(sh_planar: jnp.ndarray, x: jnp.ndarray,
                       y: jnp.ndarray, z: jnp.ndarray, sh_deg: int):
    """Row-form SH -> RGB: three (N,) color rows from planar coefficients.

    ``sh_planar``: (48, N) — row ``3*k + c`` is coefficient ``k``, channel
    ``c`` (the transpose of the scene's (N, 16, 3) leaf flattened to
    (N, 48)).  ``x/y/z``: unit-direction (N,) rows.

    This form is 3*k fused FMAs over (N,) rows, with no (N, k, 3)
    intermediate and no matmul precision to set.  The k-ascending f32 sum order differs from
    the einsum oracle's reduction tree by ulps (<=5e-7 observed); deg 0 is
    bit-exact.
    """
    if not 0 <= sh_deg <= 3:
        raise ValueError(f"unsupported sh_deg {sh_deg}")
    k = NUM_COEFFS[sh_deg]
    basis = sh_basis_rows(x, y, z, k)
    colors = []
    for c in range(3):
        acc = basis[0] * sh_planar[c]
        for kk in range(1, k):
            acc = acc + basis[kk] * sh_planar[3 * kk + c]
        colors.append(jnp.maximum(acc + 0.5, 0.0))
    return colors[0], colors[1], colors[2]
