"""Command-line interface — the framework's app shell.

The reference is a single-page browser app whose "API" is DOM controls wired
to trainer/viewer setters (src/main.ts:234-503).  The equivalent surface
here:

  webdgs view  scene.ply --out frames/ [--orbit 24] [--width 800] ...
  webdgs train --points scene.ply|points3D.bin --cameras <files...>
                   --images <dir> [--iterations N] [--lr-pos ...] ...
  webdgs render ckpt.npz --out img.png [--view 0]
  webdgs export ckpt.npz --out scene.ply
  webdgs serve scene.ply [--port 8000]              # view mode
  webdgs serve --train --points ... --cameras ... --images ...
                                        # live training in the browser

Flag names and defaults mirror the reference's slider surface
(index.html:105-179, SURVEY.md section 5).
"""

from __future__ import annotations

import argparse
import sys


def _add_train_args(t, required: bool):
    """Dataset + training flags, shared by ``train`` and ``serve --train``.
    Flag names and defaults mirror the reference's slider surface
    (index.html:105-179, trainer.ts:100-164, adam-config.ts:12-21)."""
    t.add_argument("--points", required=required,
                   help="initial PLY or COLMAP points3D.bin")
    t.add_argument("--cameras", nargs="+", required=required,
                   help="images.bin + cameras.bin, or a cameras JSON")
    t.add_argument("--images", required=required, help="image dir or files")
    t.add_argument("--iterations", type=int, default=10_000)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--config", default=None,
                   help="JSON file of deep-partial TrainerConfig overrides")
    t.add_argument("--resume", default=None,
                   help="checkpoint .npz to resume from")
    t.add_argument("--holdout-every", type=int, default=0,
                   help="hold out every k-th view for evaluation (3DGS "
                   "convention: 8); 0 trains on everything")
    t.add_argument("--shard", choices=("none", "dp", "gs"), default="none",
                   help="multi-card training over all visible devices: "
                   "dp = view-data-parallel (scene replicated, gradients "
                   "psum-reduced); gs = fully sharded (scene + optimizer "
                   "on the gaussian axis with entry exchange). 'none' "
                   "trains single-device")
    # loss (trainer.ts:100-104)
    t.add_argument("--lambda-l1", type=float, default=0.8)
    t.add_argument("--lambda-l2", type=float, default=0.0)
    t.add_argument("--lambda-dssim", type=float, default=0.2)
    # adam (adam-config.ts:12-21)
    t.add_argument("--lr-pos", type=float, default=0.00016)
    t.add_argument("--lr-color", type=float, default=0.0025)
    t.add_argument("--lr-opacity", type=float, default=0.05)
    t.add_argument("--lr-scale", type=float, default=0.005)
    t.add_argument("--lr-rot", type=float, default=0.001)
    t.add_argument("--full-sh", action="store_true",
                   help="train all SH bands (reference trains DC only)")
    t.add_argument("--lr-pos-final", type=float, default=0.0,
                   help="enable exponential position-lr decay to this value")
    t.add_argument("--bias-correction", action="store_true",
                   help="enable Adam bias correction (reference omits it)")
    # densify (trainer.ts:147-164)
    t.add_argument("--no-densify", action="store_true")
    t.add_argument("--densify-warmup", type=int, default=500)
    t.add_argument("--densify-interval", type=int, default=100)
    t.add_argument("--densify-stop", type=int, default=15_000)
    t.add_argument("--metric-views", type=int, default=10)
    t.add_argument("--metric-downscale", type=int, default=2)
    t.add_argument("--metric-threshold", type=float, default=0.5)
    t.add_argument("--max-new-points", type=int, default=5000)
    t.add_argument("--prune-opacity", type=float, default=0.01)
    t.add_argument("--clone-threshold", type=int, default=500)
    t.add_argument("--split-scale-threshold", type=float, default=1.0)


def _add_common_render_args(p):
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--max-splat-radius-px", type=float, default=128.0)
    p.add_argument("--background", type=float, nargs=3,
                   default=(0.0, 0.0, 0.0))
    p.add_argument("--gaussian-scaling", type=float, default=1.0,
                   help="splat-size multiplier (the reference's Gaussian "
                   "scale slider)")


def _settings(args):
    from webdgs.config import RenderSettings
    return RenderSettings(max_splat_radius_px=args.max_splat_radius_px,
                          background=tuple(args.background),
                          gaussian_scaling=args.gaussian_scaling)


def cmd_view(args):
    from webdgs.io.ply import load_point_cloud
    from webdgs.render.viewer import frames_to_video, render_orbit

    scene = load_point_cloud(args.scene)
    print(f"loaded {int(scene.num_alive())} points, sh_deg={scene.sh_deg}")
    paths = render_orbit(scene, args.out, n_frames=args.orbit,
                         width=args.width, height=args.height,
                         settings=_settings(args), radius=args.radius)
    print(f"wrote {len(paths)} frames to {args.out}")
    if args.video:
        out = frames_to_video(paths, args.video, fps=args.fps)
        print(f"encoded {out}")


def _build_trainer(args):
    """Load the dataset and construct a Trainer from CLI flags (shared by
    ``train`` and ``serve --train``)."""
    from webdgs.io.colmap import load_cameras
    from webdgs.io.images import load_images
    from webdgs.io.ply import load_point_cloud
    from webdgs.ops.adam import AdamHyperparameters
    from webdgs.ops.loss import LossConfig
    from webdgs.train.config import (DensifyPruneConfig, DensifySchedule,
                                         TrainerConfig)
    from webdgs.train.trainer import Trainer

    scene = load_point_cloud(args.points)
    cameras = load_cameras(args.cameras)
    images = load_images(args.images)

    # pair cameras and images by index after name-sorting, like the
    # reference (trainer.ts:573-575 + load-images name sort); cameras sort
    # by img_name when present for stability
    if all(c.img_name for c in cameras):
        from webdgs.io.images import numeric_key
        cameras = sorted(cameras, key=lambda c: numeric_key(c.img_name))
    n = min(len(cameras), len(images))
    cameras, images = cameras[:n], images[:n]
    holdout = ([], [])
    k = getattr(args, "holdout_every", 0) or 0
    if k > 1:
        # standard 3DGS eval convention: every k-th view is held out
        holdout = ([c for i, c in enumerate(cameras) if i % k == 0],
                   [m for i, m in enumerate(images) if i % k == 0])
        cameras = [c for i, c in enumerate(cameras) if i % k != 0]
        images = [m for i, m in enumerate(images) if i % k != 0]
    print(f"dataset: {len(cameras)} train / {len(holdout[0])} holdout "
          f"views; {int(scene.num_alive())} initial points")

    cfg = TrainerConfig(
        loss=LossConfig(lambda_l1=args.lambda_l1, lambda_l2=args.lambda_l2,
                        lambda_dssim=args.lambda_dssim),
        adam=AdamHyperparameters(
            lr_pos=args.lr_pos, lr_color=args.lr_color,
            lr_opacity=args.lr_opacity, lr_scale=args.lr_scale,
            lr_rot=args.lr_rot, full_sh=args.full_sh,
            bias_correction=args.bias_correction,
            lr_pos_final=args.lr_pos_final,
            lr_pos_decay_steps=args.iterations),
        densify=DensifyPruneConfig(
            schedule=DensifySchedule(
                enabled=not args.no_densify,
                warmup_iterations=args.densify_warmup,
                interval=args.densify_interval,
                stop_iterations=args.densify_stop),
            metric_views=args.metric_views,
            metric_downscale=args.metric_downscale,
            metric_threshold=args.metric_threshold,
            max_new_points_per_step=args.max_new_points,
            prune_opacity=args.prune_opacity,
            clone_threshold_count=args.clone_threshold,
            split_scale_threshold=args.split_scale_threshold),
        max_iterations=args.iterations,
        seed=args.seed)

    if args.config:
        from webdgs.train.config import load_trainer_config
        cfg = load_trainer_config(args.config, base=cfg)

    shard = getattr(args, "shard", "none")
    if shard == "none":
        trainer = Trainer(scene, cameras, images, cfg, _settings(args))
    else:
        from webdgs.parallel.sharding import make_mesh
        if shard == "dp":
            mesh = make_mesh(axis_name="dp")
            print(f"sharding 'dp' over {mesh.devices.size} device(s)")
            trainer = Trainer(scene, cameras, images, cfg, _settings(args),
                              mesh=mesh)
        else:
            from webdgs.parallel.gs_trainer import GsTrainer
            mesh = make_mesh(axis_name="band")
            print(f"sharding 'gs' over {mesh.devices.size} device(s)")
            trainer = GsTrainer(scene, cameras, images, cfg,
                                _settings(args), mesh=mesh)
    if args.resume:
        from webdgs.io.checkpoint import load_checkpoint
        ck_scene, ck_opt, meta = load_checkpoint(args.resume)
        trainer.resume_from(ck_scene, ck_opt, meta.get("iteration") or 0)
        print(f"resumed from {args.resume} at iteration "
              f"{trainer.iteration}")
    # host-side CameraData records (paired with the training groups by
    # construction): the serve viewer's camera-preset jump needs them
    # (the reference's camera-choice select, index.html:236,
    # camera.ts:196-205)
    trainer.dataset_cameras = cameras
    return trainer, holdout


def cmd_train(args):
    import json
    from webdgs.io.checkpoint import save_checkpoint
    from webdgs.io.ply import save_ply

    trainer, holdout = _build_trainer(args)
    trainer.train(log_every=args.log_every,
                  checkpoint_every=args.checkpoint_every,
                  checkpoint_path=args.out)

    # persist the model BEFORE the (potentially long) evaluation so an
    # eval failure or interrupt cannot lose the training result
    if args.out:
        save_checkpoint(args.out, trainer.scene, trainer.opt_state,
                        iteration=trainer.iteration)
        print(f"checkpoint -> {args.out}")
    if args.export_ply:
        n_out = save_ply(trainer.scene, args.export_ply)
        print(f"exported {n_out} splats -> {args.export_ply}")

    report = {"iterations": trainer.iteration,
              "points": trainer.num_points,
              "iters_per_sec": round(trainer.iters_per_sec, 2),
              "train": trainer.evaluate()}
    if holdout[0]:
        report["holdout"] = trainer.evaluate(views=holdout)
    print("eval:", json.dumps(report))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report -> {args.report}")


def _load_scene_any(path):
    from webdgs.io.checkpoint import load_checkpoint
    from webdgs.io.ply import load_point_cloud
    if str(path).endswith(".npz"):
        scene, _, _ = load_checkpoint(path)
        return scene
    return load_point_cloud(path)


def cmd_render(args):
    import numpy as np
    from webdgs.render.viewer import Viewer, save_png

    scene = _load_scene_any(args.scene)
    viewer = Viewer(scene, args.width, args.height, _settings(args))
    if args.position:
        viewer.control.position = np.asarray(args.position, np.float32)
    else:
        viewer.frame_scene()
    img = viewer.render()
    save_png(args.out, img)
    print(f"rendered {args.width}x{args.height} -> {args.out}")


def cmd_export(args):
    from webdgs.io.ply import save_ply
    scene = _load_scene_any(args.scene)
    n = save_ply(scene, args.out)
    print(f"exported {n} splats -> {args.out}")


def cmd_serve(args):
    import numpy as np
    from webdgs.render.server import ViewerServer
    from webdgs.render.viewer import Viewer

    trainer, holdout = None, None
    if args.train:
        if not (args.points and args.cameras and args.images):
            raise SystemExit("serve --train requires --points, --cameras "
                             "and --images")
        trainer, holdout = _build_trainer(args)
        scene = trainer.scene
    elif args.scene:
        scene = _load_scene_any(args.scene)
    else:
        raise SystemExit("serve needs a scene argument (view mode) or "
                         "--train with dataset flags")
    viewer = Viewer(scene, args.width, args.height, _settings(args))
    if args.position:
        viewer.control.position = np.asarray(args.position, np.float32)
    else:
        viewer.frame_scene()
    ViewerServer(viewer, trainer=trainer, holdout=holdout).serve(
        port=args.port, host=args.host)


def cmd_bench(args):
    import bench
    bench.main([])


def build_parser():
    p = argparse.ArgumentParser("webdgs",
                                description="3D Gaussian "
                                "Splatting trainer/viewer")
    sub = p.add_subparsers(dest="command", required=True)

    v = sub.add_parser("view", help="orbit-render a splat to PNG frames")
    v.add_argument("scene")
    v.add_argument("--out", default="frames")
    v.add_argument("--orbit", type=int, default=24)
    v.add_argument("--radius", type=float, default=None)
    v.add_argument("--video", default=None, metavar="PATH",
                   help="also encode the frames (.gif via PIL; other "
                        "extensions via ffmpeg when available)")
    v.add_argument("--fps", type=int, default=12)
    _add_common_render_args(v)
    v.set_defaults(fn=cmd_view)

    t = sub.add_parser("train", help="train a scene from COLMAP data")
    _add_train_args(t, required=True)
    t.add_argument("--log-every", type=int, default=100)
    t.add_argument("--out", default="checkpoint.npz")
    t.add_argument("--export-ply", default=None)
    t.add_argument("--checkpoint-every", type=int, default=0,
                   help="save --out every N iterations")
    t.add_argument("--report", default=None,
                   help="write the end-of-training eval JSON to this file")
    _add_common_render_args(t)
    t.set_defaults(fn=cmd_train)

    r = sub.add_parser("render", help="render one frame from a scene or "
                       "checkpoint")
    r.add_argument("scene")
    r.add_argument("--out", default="render.png")
    r.add_argument("--position", type=float, nargs=3, default=None)
    _add_common_render_args(r)
    r.set_defaults(fn=cmd_render)

    e = sub.add_parser("export", help="export a checkpoint to PLY")
    e.add_argument("scene")
    e.add_argument("--out", required=True)
    e.set_defaults(fn=cmd_export)

    sv = sub.add_parser("serve", help="interactive browser viewer "
                        "(JPEG stream + fly controls); --train runs live "
                        "training while you watch, like the reference app")
    sv.add_argument("scene", nargs="?", default=None,
                    help="PLY/checkpoint to view (omit with --train)")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--position", type=float, nargs=3, default=None)
    sv.add_argument("--train", action="store_true",
                    help="train while viewing (requires dataset flags)")
    _add_train_args(sv, required=False)
    _add_common_render_args(sv)
    sv.set_defaults(fn=cmd_serve)

    b = sub.add_parser("bench", help="run the headline benchmark")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    from webdgs.config import enable_compilation_cache
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
