"""Loss pixel-gradients and image metrics.

The reference never computes a scalar loss — its loss kernel writes dL/dpixel
directly (src/shaders/loss.wgsl:85-115):

    grad = lambda_l1 * sign(pred - targ)
         + lambda_l2 * (pred - targ)
         + lambda_dssim * ((1 - ssim_map)/2) * (pred - targ)

where ssim_map is a per-pixel 5x5 uniform-window SSIM with edge-clamped
sampling (loss.wgsl:20-44) — note this "DSSIM gradient" is the reference's
simplification, not the true derivative of DSSIM; we reproduce it exactly
and feed it to the renderer VJP as the pixel cotangent.

We additionally provide real scalar metrics (L1/L2/DSSIM/PSNR) for
reporting, which the reference lacks entirely (SURVEY.md section 5: no
PSNR/SSIM is ever computed).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Defaults from src/trainer.ts:100-104 and
    src/renderers/tiled-backward-pass.ts:168-174."""

    lambda_l1: float = 0.8
    lambda_l2: float = 0.0
    lambda_dssim: float = 0.2
    c1: float = 1e-4
    c2: float = 9e-4


def _window_mean(x: jax.Array, half: int = 2) -> jax.Array:
    """5x5 uniform window mean with edge-replicated sampling, matching the
    reference's clamped textureLoad (loss.wgsl:20-28)."""
    pad = [(half, half), (half, half), (0, 0)]
    xp = jnp.pad(x, pad, mode="edge")
    win = 2 * half + 1
    s = jax.lax.reduce_window(
        xp, 0.0, jax.lax.add,
        window_dimensions=(win, win, 1),
        window_strides=(1, 1, 1),
        padding="VALID")
    return s / (win * win)


def ssim_map(pred: jax.Array, target: jax.Array,
             c1: float = 1e-4, c2: float = 9e-4) -> jax.Array:
    """Per-pixel 5x5-window SSIM (loss.wgsl:30-72), per channel."""
    mu_x = _window_mean(pred)
    mu_y = _window_mean(target)
    sigma_x2 = _window_mean(pred * pred) - mu_x * mu_x
    sigma_y2 = _window_mean(target * target) - mu_y * mu_y
    sigma_xy = _window_mean(pred * target) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x2 + sigma_y2 + c2)
    return num / den


def pixel_loss_gradient(pred: jax.Array, target: jax.Array,
                        cfg: LossConfig) -> jax.Array:
    """dL/dpixel, (H, W, 3), with the reference's exact formulas."""
    diff = pred - target
    grad = cfg.lambda_l1 * jnp.sign(diff) + cfg.lambda_l2 * diff
    if cfg.lambda_dssim > 0.0:
        dssim = (1.0 - ssim_map(pred, target, cfg.c1, cfg.c2)) * 0.5
        grad = grad + cfg.lambda_dssim * dssim * diff
    return grad


def loss_metrics(pred: jax.Array, target: jax.Array,
                 cfg: LossConfig) -> dict[str, jax.Array]:
    diff = pred - target
    l1 = jnp.mean(jnp.abs(diff))
    l2 = jnp.mean(diff * diff)
    dssim = jnp.mean((1.0 - ssim_map(pred, target, cfg.c1, cfg.c2)) * 0.5)
    total = cfg.lambda_l1 * l1 + cfg.lambda_l2 * l2 + cfg.lambda_dssim * dssim
    return {
        "l1": l1,
        "l2": l2,
        "dssim": dssim,
        "loss": total,
        "psnr": psnr(pred, target),
    }


def psnr(pred: jax.Array, target: jax.Array) -> jax.Array:
    mse = jnp.mean(jnp.square(pred - target))
    return -10.0 * jnp.log10(jnp.maximum(mse, 1e-12))


def ssim(pred: jax.Array, target: jax.Array, window: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> jax.Array:
    """Standard Gaussian-window SSIM (Wang et al.) for quality reporting.
    The 5x5 uniform-window variant in ssim_map exists only for parity with
    the reference's loss kernel."""
    half = window // 2
    x = jnp.arange(window, dtype=jnp.float32) - half
    g = jnp.exp(-0.5 * (x / sigma) ** 2)
    g = g / jnp.sum(g)

    def blur(img):
        pad = [(half, half), (half, half), (0, 0)]
        v = jnp.pad(img, pad, mode="edge")
        v = v.transpose(2, 0, 1)[:, None]  # (C, 1, H', W')
        # HIGHEST precision: a reduced-precision conv (TF32 on the GPU)
        # rounds the blurs, and the variance cancellation
        # blur(x^2) - mu^2 then dwarfs c2=9e-4 (SSIM "means" > 1).  The
        # blur is tiny; exactness is free.
        v = jax.lax.conv_general_dilated(
            v, g.reshape(1, 1, window, 1), (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST)
        v = jax.lax.conv_general_dilated(
            v, g.reshape(1, 1, 1, window), (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST)
        return v[:, 0].transpose(1, 2, 0)

    mu_x = blur(pred)
    mu_y = blur(target)
    sigma_x2 = blur(pred * pred) - mu_x * mu_x
    sigma_y2 = blur(target * target) - mu_y * mu_y
    sigma_xy = blur(pred * target) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x2 + sigma_y2 + c2)
    return jnp.mean(num / den)
