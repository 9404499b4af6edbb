"""The jitted training step: forward render, loss cotangent, two-stage VJP,
Adam update.

Mirrors one iteration of the reference's ``Trainer.step()``
(src/trainer.ts:568-660), which encodes forward + rasterize + loss +
backward-rasterize + backward-geometry + adam + repack into ONE command
buffer with zero readbacks — exactly the shape of one jitted step.

The gradient flow is split into two VJPs so the reference's quirky SH
gradient routing can be reproduced: the rasterizer VJP yields per-Gaussian
cotangents for (center_px, conic, color, opacity, extents) — the analogue of
the reference's grad_means_2d/grad_conics/grad_colors/grad_opacity atomic
buffers — and the projection VJP chains them to the 3D parameters
(replacing the 304-line hand-derived src/shaders/tiled-backward.wgsl).

Parity details handled here:
  * SH DC gradient = raw dL/dcolor without the SH_C0 factor or clamp mask
    (SURVEY.md Q2; adam.wgsl:160-174) unless ``adam.full_sh`` is set;
  * the screen-radius-cap guard keeps only positive (shrinking) log-scale
    gradients for radius-capped Gaussians (tiled-backward.wgsl:261-283);
  * Adam visibility gating via per-Gaussian tile counts
    (tiled-forward.wgsl:169,289; adam.wgsl:74-76).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from webdgs.config import DEFAULT_SETTINGS, RenderSettings
from webdgs.core.camera import Camera
from webdgs.core.scene import GaussianScene
from webdgs.ops import binning as binning_ops
from webdgs.ops import rasterize as raster_ops
from webdgs.ops.adam import AdamHyperparameters, AdamState, adam_step
from webdgs.ops.loss import (LossConfig, loss_metrics,
                                 pixel_loss_gradient)
from webdgs.ops.projection import project_gaussians
from webdgs.render.renderer import render_from_attrs


class TrainStepResult(NamedTuple):
    scene: GaussianScene
    opt_state: AdamState
    metrics: dict[str, jax.Array]


def compute_param_grads(scene: GaussianScene, camera: Camera,
                        target: jax.Array, img_w: int, img_h: int,
                        loss_cfg: LossConfig, settings: RenderSettings,
                        parity_sh: bool, entry_capacity: int | None = None):
    """Returns (image, param grads dict, aux, entry_demand) — the last is
    the binning's pre-drop entry demand (post-cull; see
    ``Binning.expansion_entries``), the observation capacity adaptation
    needs."""
    params = scene.params()

    def proj_fn(p):
        attrs, aux = project_gaussians(p, scene.alive, camera, img_w, img_h,
                                       scene.sh_deg, settings,
                                       detach_color=parity_sh)
        return attrs, aux

    attrs, vjp_proj, aux = jax.vjp(proj_fn, params, has_aux=True)

    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)

    def img_fn(a):
        out, bins = render_from_attrs(a, aux, img_w, img_h, settings,
                                      entry_capacity, for_grad=True)
        tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h,
                                          settings)
        return (raster_ops.composite_background(tiles, settings),
                bins.expansion_entries)

    image, vjp_raster, entry_demand = jax.vjp(img_fn, attrs, has_aux=True)
    pgrad = pixel_loss_gradient(image, target, loss_cfg)
    (d_attrs,) = vjp_raster(pgrad)
    (d_params,) = vjp_proj(d_attrs)

    # Q2 SH routing + screen-radius-cap guard (tiled-backward.wgsl:261-283)
    d_params = _apply_grad_parity(d_params, d_attrs, aux, params, parity_sh)
    return image, d_params, aux, entry_demand


def _apply_grad_parity(d_params, d_attrs, aux, params, parity_sh):
    """The two post-VJP parity adjustments (also applied by the sharded
    step, parallel/sharding.py)."""
    if parity_sh:
        # Q2: route raw dL/dcolor straight into the DC coefficient
        d_sh = jnp.zeros_like(params["sh"]).at[:, 0, :].set(d_attrs.color)
        d_params = {**d_params, "sh": d_sh}
    g_ls = d_params["log_scales"]
    return {**d_params, "log_scales": jnp.where(
        aux.radius_capped[:, None], jnp.maximum(g_ls, 0.0), g_ls)}


@functools.partial(
    jax.jit,
    static_argnames=("img_w", "img_h", "loss_cfg", "hp", "settings",
                     "entry_capacity"))
def train_step(scene: GaussianScene, opt_state: AdamState, camera: Camera,
               target: jax.Array, *, img_w: int, img_h: int,
               loss_cfg: LossConfig = LossConfig(),
               hp: AdamHyperparameters = AdamHyperparameters(),
               settings: RenderSettings = DEFAULT_SETTINGS,
               entry_capacity: int | None = None) -> TrainStepResult:
    image, d_params, aux, entry_demand = compute_param_grads(
        scene, camera, target, img_w, img_h, loss_cfg, settings,
        parity_sh=not hp.full_sh, entry_capacity=entry_capacity)
    metrics = loss_metrics(image, target, loss_cfg)

    new_params, new_opt = adam_step(scene.params(), d_params, opt_state, hp,
                                    aux.num_tiles)
    # the reference's pipeline-stats counters (update-stats.wgsl,
    # tiled-forward.wgsl:292): visible splats + total tile entries.
    # tile_entries is the binning's pre-drop demand — post-cull, so
    # capacity adaptation sizes the sort to the survivors, not the rects
    metrics["visible"] = jnp.sum(aux.visible.astype(jnp.int32))
    metrics["tile_entries"] = entry_demand
    return TrainStepResult(scene=scene.with_params(new_params),
                           opt_state=new_opt, metrics=metrics)
