"""End-to-end training validation on real hardware (BASELINE configs 3/4).

Builds a synthetic "ground truth" splat scene, renders a COLMAP-style
multi-view dataset from it, initializes training from a noisy point cloud
(like a real run starts from points3D.bin), trains with the full loop —
including the densify/prune schedule — and reports PSNR on a held-out view.

Usage: python scripts/validate_training.py [--iters 2000] [--views 20]
"""

from __future__ import annotations

import argparse
import json
import math
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--size", type=int, nargs=2, default=(400, 304))
    ap.add_argument("--gt-points", type=int, default=20_000)
    ap.add_argument("--init-points", type=int, default=4_000)
    ap.add_argument("--no-densify", action="store_true")
    ap.add_argument("--improved", action="store_true",
                    help="enable the non-parity improvements: full-SH "
                         "training, Adam bias correction, position-lr decay")
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (for quick logic checks)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from webdgs.config import RenderSettings, enable_compilation_cache
    enable_compilation_cache()
    from webdgs.core.camera import CameraData, make_camera
    from webdgs.core.scene import scene_from_arrays
    from webdgs.ops.loss import psnr
    from webdgs.render.renderer import render
    from webdgs.render.viewer import look_at_rotation
    from webdgs.train.config import (DensifyPruneConfig, DensifySchedule,
                                         TrainerConfig)
    from webdgs.train.trainer import Trainer

    w, h = args.size
    settings = RenderSettings(chunk=128)
    rng = np.random.default_rng(0)

    # ground truth: a blobby structured scene (clustered gaussians)
    k = 40
    centers = rng.normal(0, 1.2, (k, 3))
    n = args.gt_points
    asn = rng.integers(0, k, n)
    means = centers[asn] + rng.normal(0, 0.25, (n, 3))
    quats = rng.normal(0, 1, (n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    gt = scene_from_arrays(
        means.astype(np.float32), quats.astype(np.float32),
        rng.uniform(-4.6, -3.2, (n, 3)).astype(np.float32),
        rng.uniform(0.0, 3.0, (n,)).astype(np.float32),
        colors=np.clip(rng.normal(0.5, 0.25, (n, 3)), 0, 1).astype(np.float32))

    # cameras on a ring
    fy = 0.5 * h / math.tan(math.radians(50.0) / 2)
    cams_data, images = [], []
    n_all = args.views + 1
    for i in range(n_all):
        az = 2 * math.pi * i / n_all
        pos = 6.0 * np.array([math.sin(az), 0.25, math.cos(az)])
        rot = look_at_rotation(pos, np.zeros(3))
        cd = CameraData(id=i, position=pos.astype(np.float32), rotation=rot,
                        fx=fy, fy=fy, width=w, height=h,
                        img_name=f"v{i:03d}.png")
        img = np.asarray(render(gt, make_camera(cd), w, h, settings).image)
        cams_data.append(cd)
        images.append({"name": cd.img_name, "image": img, "width": w,
                       "height": h})

    hold_cam, hold_img = cams_data[-1], images[-1]
    cams_data, images = cams_data[:-1], images[:-1]

    # init: subsampled noisy GT points with colors (points3D.bin analogue)
    sel = rng.choice(n, args.init_points, replace=False)
    init = scene_from_arrays(
        (means[sel] + rng.normal(0, 0.05, (len(sel), 3))).astype(np.float32),
        colors=np.clip(rng.normal(0.5, 0.25, (len(sel), 3)), 0,
                       1).astype(np.float32))

    from webdgs.ops.adam import AdamHyperparameters
    adam = AdamHyperparameters()
    if args.improved:
        adam = AdamHyperparameters(full_sh=True, bias_correction=True,
                                   lr_pos_final=1.6e-6,
                                   lr_pos_decay_steps=args.iters)
    cfg = TrainerConfig(
        adam=adam,
        densify=DensifyPruneConfig(
            schedule=DensifySchedule(enabled=not args.no_densify,
                                     warmup_iterations=300, interval=100,
                                     stop_iterations=args.iters * 3 // 4),
            metric_views=8, clone_threshold_count=50,
            max_new_points_per_step=5000),
        max_iterations=args.iters)
    trainer = Trainer(init, cams_data, images, cfg, settings)

    hold = make_camera(hold_cam)
    img0 = jax.jit(lambda sc: render(sc, hold, w, h,
        settings).image)(trainer.scene)
    psnr0 = float(psnr(img0, jnp.asarray(hold_img["image"])))
    print(f"init: {trainer.num_points} points, held-out PSNR {psnr0:.2f} dB",
          flush=True)

    t0 = time.time()
    trainer.train(log_every=200)
    wall = time.time() - t0

    img1 = jax.jit(lambda sc: render(sc, hold, w, h,
        settings).image)(trainer.scene)
    psnr1 = float(psnr(img1, jnp.asarray(hold_img["image"])))
    result = {
        "iters": trainer.iteration,
        "wall_s": round(wall, 1),
        "iters_per_sec": round(trainer.iteration / wall, 2),
        "points_final": trainer.num_points,
        "psnr_holdout_init": round(psnr0, 2),
        "psnr_holdout_final": round(psnr1, 2),
        "train_psnr_final": round(float(trainer.last_metrics["psnr"]), 2),
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
