"""Smoke test of the GPU path: drives training, rendering and serving
through the entry points a user calls, and checks the compiled rasterizer
kernels against their plain reference at full width.

    python chip_smoke.py            # one card: every single-card phase
    python chip_smoke.py --cards 4  # four cards: the multi-card phase only

Phases (one card): device, kernels (100k and 1M Gaussians at 800x600),
train (CLI on a generated 800x600 COLMAP scene, densify + capacity growth,
PLY export), view/serve (orbit, render, a banded 4K frame, JPEG frames
from a ViewerServer), scale (1M Gaussians: train steps and frames).  Any
failed check raises and exits non-zero.  Each phase prints one line naming
the card; the last line is one JSON object.  The process reserves most of
the card's memory, so run it alone on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# sizes: the frame, the two kernel/scale scenes, the CLI training run and
# the banded frame
W, H = 800, 600
N_SMALL, N_LARGE = 100_000, 1_000_000
# training: densify every DENSIFY_EVERY iterations until DENSIFY_STOP, so
# the last rate window (100 iterations) has no densify recompiles
TRAIN_POINTS, TRAIN_ITERS = 160_000, 500
DENSIFY_EVERY, DENSIFY_STOP = 100, 250
BIG_W, BIG_H = 3840, 2160
# rasterizer output vs the plain reference (RGB, acc alpha, T), and the
# per-Gaussian gradients through the custom_vjp (see PERF.md)
TOL_IMAGE_ABS = 1e-4
TOL_GRAD_REL_L2 = 1e-3
# multi-card step vs the one-card step on the same batch: loss, and the
# parameter update (Adam's first step is ~lr*sign(g), so an atomics-order
# sign flip of a near-zero gradient moves single elements by ~2*lr)
TOL_LOSS_REL = 1e-4
TOL_DELTA_REL_L2 = 2e-2
# the f16 entry exchange rounds splat attributes to 11 mantissa bits
TOL_LOSS_REL_F16 = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    """The card's name and power limit, read by a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


class Phases:
    def __init__(self, card: str):
        self.card = card

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        print(f"[{name}] start", flush=True)
        yield
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s | card: "
              f"{self.card}", flush=True)


def random_scene(n: int, spread: float, log_scale: tuple, opacity: tuple,
                 seed: int = 0):
    from webdgs.core.scene import scene_from_arrays

    rng = np.random.default_rng(seed)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return scene_from_arrays(
        rng.normal(0, spread, (n, 3)).astype(np.float32), quats=quats,
        log_scales=rng.uniform(*log_scale, (n, 3)).astype(np.float32),
        opacity_logits=rng.uniform(*opacity, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32))


def scene_100k():
    """The 100k/800x600 benchmark scene (bench.py)."""
    from webdgs.core.camera import default_camera
    return (random_scene(N_SMALL, 1.5, (-4.5, -2.5), (-1, 3)),
            default_camera(W, H, position=(0.0, 0.0, -8.0)))


def scene_1m():
    """1M Gaussians at 800x600: a wider, smaller, more transparent cloud."""
    from webdgs.core.camera import default_camera
    return (random_scene(N_LARGE, 2.5, (-5.5, -3.5), (-2, 2)),
            default_camera(W, H, position=(0.0, 0.0, -10.0)))


def target_for(scene, cam, settings):
    """A ground truth the scene does not match: the same splats, more
    opaque."""
    from webdgs.render.renderer import render_compiled
    return render_compiled(scene.replace(
        opacity_logits=scene.opacity_logits + 1.0), cam, img_w=W, img_h=H,
        settings=settings).image


def peak_bytes_in_use() -> int:
    import jax
    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def entry_demand(scene, cam, settings) -> int:
    import jax

    from webdgs.ops import binning
    from webdgs.ops.projection import project_gaussians

    @jax.jit
    def demand(sc):
        attrs, aux = project_gaussians(sc.params(), sc.alive, cam, W, H,
                                       sc.sh_deg, settings)
        return binning.bin_splats(aux, W, H, settings,
                                  attrs=attrs).expansion_entries
    return int(demand(scene))


def adaptive_capacity(scene, cam, settings) -> int:
    """The entry capacity the Trainer settles on (1.2x observed)."""
    from webdgs.config import quantize_budget
    from webdgs.train.trainer import Trainer
    return quantize_budget(
        entry_demand(scene, cam, settings) * Trainer.ENTRY_CAP_HEADROOM,
        settings.chunk, settings.chunk * 8)


def time_train_steps(scene, cam, target, settings, cap, steps: int):
    """Donated steady-state steps, like the Trainer's step jit.  Returns
    (ms/step, compile s, the compiled step, final metrics).  The target is
    an argument: as a captured constant XLA would fold its SSIM blurs at
    compile time."""
    import jax

    from webdgs.ops.adam import init_adam_state
    from webdgs.train.step import train_step

    step = jax.jit(lambda s, o, t: train_step(
        s, o, cam, t, img_w=W, img_h=H, settings=settings,
        entry_capacity=cap), donate_argnums=(0, 1))
    s = jax.tree.map(lambda x: x.copy(), scene)
    o = init_adam_state(scene.params())
    t0 = time.perf_counter()
    compiled = step.lower(s, o, target).compile()
    comp = time.perf_counter() - t0
    s, o, m = compiled(s, o, target)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    for _ in range(steps):
        s, o, m = compiled(s, o, target)
    jax.block_until_ready(s)
    return ((time.perf_counter() - t0) / steps * 1e3, comp, compiled,
            {k: float(v) for k, v in m.items()})


def kernels_at(label, scene, cam, settings):
    """Kernel vs plain reference at one scene size: image, per-entry and
    per-Gaussian gradients, determinism, and the train step both ways."""
    import jax
    import jax.numpy as jnp

    from webdgs.ops import binning
    from webdgs.ops import rasterize as raster
    from webdgs.ops.projection import project_gaussians

    cap = adaptive_capacity(scene, cam, settings)
    attrs, aux = jax.jit(lambda sc: project_gaussians(
        sc.params(), sc.alive, cam, W, H, sc.sh_deg, settings))(scene)
    bins = jax.jit(lambda a, x: binning.bin_splats(
        x, W, H, settings, capacity=cap, attrs=a))(attrs, aux)
    check(int(bins.expansion_entries) <= cap, f"{label}: capacity overflow")
    ntx, nty = binning.tile_grid(W, H, settings)
    valid = np.asarray(bins.entry_valid)
    ct = jnp.asarray(np.random.default_rng(1).normal(
        size=(ntx * nty, raster.NUM_OUT, settings.tile_px)).astype(
        np.float32)).at[:, raster.OUT_NCONTRIB].set(0.0)

    def loss(fn, a):
        a16 = raster.pack_entry_attrs(a, bins.entry_gauss, bins.entry_valid)
        return jnp.sum(fn(a16, bins.tile_offsets, ntx, nty, settings,
                          False) * ct)

    def entry_grad(fn, a16):
        return jax.vjp(lambda x: fn(x, bins.tile_offsets, ntx, nty,
                                    settings, False), a16)[1](ct)[0]

    a16 = raster.pack_entry_attrs(attrs, bins.entry_gauss, bins.entry_valid)
    res = {}
    with jax.default_matmul_precision("highest"):
        for name, fn in (("kernel", raster.rasterize_tiles),
                         ("plain", raster.rasterize_tiles_plain)):
            fwd = jax.jit(lambda x: fn(x, bins.tile_offsets, ntx, nty,
                                       settings))
            bwd = jax.jit(functools.partial(entry_grad, fn))
            per_g = jax.jit(jax.grad(functools.partial(loss, fn)))
            res[name] = (np.asarray(fwd(a16)), np.asarray(bwd(a16)),
                         jax.device_get(per_g(attrs)))
            if name == "kernel":
                again = np.asarray(bwd(a16))
                per_g_again = jax.device_get(per_g(attrs))
    (out_k, d_k, g_k), (out_p, d_p, g_p) = res["kernel"], res["plain"]
    err_img = float(np.abs(out_k[:, :raster.OUT_NCONTRIB]
                           - out_p[:, :raster.OUT_NCONTRIB]).max())
    err_nc = float(np.abs(out_k[:, raster.OUT_NCONTRIB]
                          - out_p[:, raster.OUT_NCONTRIB]).max())
    d_rel = float(np.linalg.norm(d_k[:, valid] - d_p[:, valid])
                  / np.linalg.norm(d_p[:, valid]))
    g_rel = {f: float(np.linalg.norm(getattr(g_k, f) - getattr(g_p, f))
                      / max(np.linalg.norm(getattr(g_p, f)), 1e-30))
             for f in ("center_px", "conic", "color", "opacity")}
    det_entry = bool(np.array_equal(d_k[:, valid], again[:, valid]))
    det_gauss = max(float(np.abs(getattr(g_k, f)
                                 - getattr(per_g_again, f)).max())
                    for f in ("center_px", "conic", "color", "opacity"))
    print(f"  {label}: entries {int(bins.total_entries)} (capacity {cap}); "
          f"image max abs err {err_img:.3e} (tol {TOL_IMAGE_ABS:g}), "
          f"n_contrib max err {err_nc:g}; per-entry grad rel-L2 "
          f"{d_rel:.3e}; per-Gaussian grad rel-L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in g_rel.items())
          + f" (tol {TOL_GRAD_REL_L2:g})", flush=True)
    print(f"  {label}: backward kernel bitwise deterministic: {det_entry}; "
          f"per-Gaussian sums (scatter-add) max run-to-run diff "
          f"{det_gauss:.3e}", flush=True)
    check(err_img <= TOL_IMAGE_ABS, f"{label}: image error {err_img}")
    check(err_nc == 0.0, f"{label}: n_contrib differs by {err_nc}")
    check(max(g_rel.values()) <= TOL_GRAD_REL_L2 and d_rel <= TOL_GRAD_REL_L2,
          f"{label}: gradient error {d_rel} {g_rel}")
    check(det_entry, f"{label}: backward kernel not deterministic")

    # the train step end to end, kernel vs plain rasterizer
    target = target_for(scene, cam, settings)
    times = {}
    for name in ("kernel", "plain"):
        jax.clear_caches()
        impl = (raster.rasterize_tiles if name == "kernel"
                else raster.rasterize_tiles_plain)
        with mock.patch.object(raster, "rasterize_tiles", impl):
            ms, comp, compiled, m = time_train_steps(scene, cam, target,
                                                     settings, cap, 10)
        times[name] = ms
        check(np.isfinite(m["loss"]), f"{label}: {name} step loss {m}")
        if name == "kernel":
            mem = compiled.memory_analysis()
    jax.clear_caches()
    print(f"  {label}: train step {times['kernel']:.2f} ms with the kernels,"
          f" {times['plain']:.2f} ms with the plain rasterizer", flush=True)
    print(f"  {label}: step memory_analysis: {mem}", flush=True)


def phase_kernels(phase):
    from webdgs.config import DEFAULT_SETTINGS

    with phase("kernels"):
        for label, (scene, cam) in (("100k/800x600", scene_100k()),
                                    ("1M/800x600", scene_1m())):
            kernels_at(label, scene, cam, DEFAULT_SETTINGS)


def run_cli(argv) -> str:
    """Run the CLI in this process, returning what it printed."""
    from webdgs import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def phase_train(phase, work: str) -> str:
    """Returns the exported PLY's path."""
    with phase("train"):
        data = os.path.join(work, "scene")
        subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "make_synthetic_colmap.py"),
             data, "--views", "8", "--width", str(W), "--height", str(H),
             "--points", str(TRAIN_POINTS), "--seed", "7"],
            check=True, capture_output=True, text=True, timeout=600)
        sparse = os.path.join(data, "sparse", "0")
        import jax

        from webdgs.io.ply import load_point_cloud
        from webdgs.train.trainer import Trainer
        n_points = int(load_point_cloud(
            os.path.join(sparse, "points3D.bin")).num_alive())
        check(n_points >= N_SMALL, f"only {n_points} points generated")
        ply = os.path.join(work, "trained.ply")
        report = os.path.join(work, "report.json")
        grown, events = [], []
        resize, densify = Trainer._on_state_resize, Trainer._run_densify

        def record_resize(trainer):
            grown.append(trainer.scene.capacity)
            resize(trainer)

        def record_densify(trainer, w, h):
            t0 = time.perf_counter()
            densify(trainer, w, h)
            jax.block_until_ready(trainer.scene)
            events.append((trainer.iteration, trainer.num_points,
                           round(time.perf_counter() - t0, 3)))

        t0 = time.perf_counter()
        with mock.patch.object(Trainer, "_on_state_resize", record_resize), \
                mock.patch.object(Trainer, "_run_densify", record_densify):
            log = run_cli([
                "train", "--points", os.path.join(sparse, "points3D.bin"),
                "--cameras", os.path.join(sparse, "images.bin"),
                os.path.join(sparse, "cameras.bin"),
                "--images", os.path.join(data, "images"),
                "--iterations", str(TRAIN_ITERS),
                "--densify-warmup", str(DENSIFY_EVERY),
                "--densify-interval", str(DENSIFY_EVERY),
                "--densify-stop", str(DENSIFY_STOP),
                "--metric-views", "4", "--clone-threshold", "10",
                "--log-every", str(DENSIFY_EVERY // 2),
                "--out", os.path.join(work, "trained.npz"),
                "--export-ply", ply, "--report", report])
        wall = time.perf_counter() - t0
        losses = [float(ln.split("loss=")[1].split()[0])
                  for ln in log.splitlines() if "loss=" in ln]
        points = [int(ln.split("points=")[1].split()[0])
                  for ln in log.splitlines() if "points=" in ln]
        with open(report) as f:
            rep = json.load(f)
        print(f"  {n_points} initial points; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} over {rep['iterations']} iterations; "
              f"densify events (iteration, points, s incl. compile) "
              f"{events}; capacity grew "
              f"to {grown}; "
              f"{rep['iters_per_sec']} it/s (steady window), {wall:.1f} s "
              f"wall incl. compiles; train PSNR {rep['train']['psnr']:.2f}",
              flush=True)
        check(rep["iterations"] == TRAIN_ITERS,
              f"ran {rep['iterations']} iters")
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
        check(events, "no densify event ran")
        check(grown, "the scene capacity never grew")
        check(os.path.getsize(ply) > 0, "PLY not written")
        return ply


def fetch_frames(viewer, n: int):
    from PIL import Image

    from webdgs.render.server import ViewerServer, make_http_server

    vs = ViewerServer(viewer)
    server = make_http_server(vs, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            jpg = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/frame.jpg", timeout=300).read()
            ms.append((time.perf_counter() - t0) * 1e3)
            img = Image.open(io.BytesIO(jpg))
            img.load()
            check(img.size == (viewer.width, viewer.height),
                  f"frame size {img.size}")
        return ms
    finally:
        server.shutdown()
        server.server_close()
        vs.shutdown()
        thread.join(timeout=30)


def phase_view_serve(phase, work: str, ply: str):
    import jax

    from webdgs.config import DEFAULT_SETTINGS, quantize_budget
    from webdgs.io.ply import load_point_cloud
    from webdgs.render.renderer import render_banded, render_compiled
    from webdgs.render.viewer import Viewer

    with phase("view/serve"):
        frames = os.path.join(work, "orbit")
        run_cli(["view", ply, "--out", frames, "--orbit", "4"])
        check(len([f for f in os.listdir(frames) if f.endswith(".png")])
              == 4, "orbit frames missing")
        png = os.path.join(work, "render.png")
        run_cli(["render", ply, "--out", png])
        check(os.path.getsize(png) > 0, "render PNG missing")

        scene = load_point_cloud(ply)
        viewer = Viewer(scene, BIG_W, BIG_H)
        viewer.frame_scene()
        cam = viewer.camera()
        # one capacity for both, above the frame's demand: a frame that
        # drops entries would differ between the band and one-grid layouts
        demand = int(render_compiled(
            scene, cam, img_w=BIG_W, img_h=BIG_H,
            settings=DEFAULT_SETTINGS).binning.expansion_entries)
        cap = quantize_budget(demand * 1.2, DEFAULT_SETTINGS.chunk,
                              DEFAULT_SETTINGS.chunk * 8)
        t0 = time.perf_counter()
        img4k = np.asarray(render_banded(scene, cam, BIG_W, BIG_H,
                                         DEFAULT_SETTINGS,
                                         entry_capacity=cap, bands=4))
        t_band = time.perf_counter() - t0
        full = np.asarray(render_compiled(scene, cam, img_w=BIG_W, img_h=BIG_H,
                                          settings=DEFAULT_SETTINGS,
                                          entry_capacity=cap).image)
        err = float(np.abs(img4k - full).max())
        print(f"  {BIG_W}x{BIG_H} banded (4 bands): {t_band:.2f} s incl. "
              "compile;"
              f" max abs diff vs one-grid frame {err:.2e}", flush=True)
        check(img4k.shape == (BIG_H, BIG_W, 3) and np.isfinite(img4k).all(),
              "4K frame malformed")
        check(err < 1e-5, f"banded 4K frame differs by {err}")
        del full, img4k
        jax.clear_caches()

        viewer = Viewer(scene, W, H)
        viewer.frame_scene()
        ms = fetch_frames(viewer, 5)
        print("  served /frame.jpg ms: " + ", ".join(f"{m:.1f}" for m in ms),
              flush=True)


def phase_scale(phase):
    import jax

    from webdgs.config import DEFAULT_SETTINGS
    from webdgs.render.renderer import render_compiled

    with phase("scale"):
        settings = DEFAULT_SETTINGS
        scene, cam = scene_1m()
        cap = adaptive_capacity(scene, cam, settings)
        target = target_for(scene, cam, settings)
        ms, comp, _, m = time_train_steps(scene, cam, target, settings, cap,
                                          10)
        render = jax.jit(lambda sc: render_compiled(
            sc, cam, img_w=W, img_h=H, settings=settings,
            entry_capacity=cap).image)
        img = render(scene)
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        for _ in range(10):
            img = render(scene)
        jax.block_until_ready(img)
        frame_ms = (time.perf_counter() - t0) / 10 * 1e3
        peak = peak_bytes_in_use()
        print(f"  {N_LARGE} Gaussians at {W}x{H} (capacity {cap}, "
              f"{int(m['tile_entries'])} entries): {ms:.2f} ms/step "
              f"({1e3 / ms:.2f} it/s, compile {comp:.1f} s), "
              f"{frame_ms:.2f} ms/frame; peak_bytes_in_use {peak}",
              flush=True)
        check(np.isfinite(m["loss"]) and np.isfinite(np.asarray(img)).all(),
              "non-finite 1M step or frame")


def phase_multicard(phase, n_cards: int):
    """dp and gaussian-sharded training on n cards: the steps against the
    one-card step on the same scene and view batch, then the Trainer and
    GsTrainer loops (the latter through one densify event)."""
    import jax
    import jax.numpy as jnp

    from webdgs.config import DEFAULT_SETTINGS
    from webdgs.core.camera import CameraData, default_camera
    from webdgs.ops.adam import init_adam_state
    from webdgs.parallel.gs_trainer import GsTrainer
    from webdgs.parallel.sharding import (dp_train_step, gs_train_step,
                                              make_mesh)
    from webdgs.render.renderer import render_compiled
    from webdgs.train.config import (DensifyPruneConfig,
                                         DensifySchedule, TrainerConfig)
    from webdgs.train.step import train_step
    from webdgs.train.trainer import Trainer

    settings = DEFAULT_SETTINGS
    devices = jax.devices()
    check(len(devices) >= n_cards, f"{len(devices)} cards, need {n_cards}")
    mesh = make_mesh(devices[:n_cards])
    mesh1 = make_mesh(devices[:1])
    scene, _ = scene_100k()
    gt = scene.replace(opacity_logits=scene.opacity_logits + 1.0)
    positions = [(0.2 * i - 0.3, 0.0, -8.0) for i in range(n_cards)]
    cams = [default_camera(W, H, position=p) for p in positions]
    cam_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    targets = jnp.stack([render_compiled(gt, c, img_w=W, img_h=H,
                                         settings=settings).image
                         for c in cams])
    opt = init_adam_state(scene.params())

    def compare(label, one, many):
        (s1, m1), (sn, mn) = one, many
        dl = abs(float(mn["loss"]) - float(m1["loss"])) / abs(
            float(m1["loss"]))
        p0, p1, pn = (jax.device_get(x.params()) for x in (scene, s1, sn))
        rel = {k: float(np.linalg.norm(pn[k] - p1[k])
                        / max(np.linalg.norm(p1[k] - p0[k]), 1e-30))
               for k in p0}
        print(f"  {label}: loss {float(mn['loss']):.6f} vs one card "
              f"{float(m1['loss']):.6f} (rel {dl:.2e}, tol "
              f"{TOL_LOSS_REL:g}); param-delta rel-L2 "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f" (tol {TOL_DELTA_REL_L2:g})", flush=True)
        check(dl <= TOL_LOSS_REL, f"{label}: loss differs by {dl}")
        check(max(rel.values()) <= TOL_DELTA_REL_L2,
              f"{label}: parameter deltas differ {rel}")

    with phase(f"multicard x{n_cards}"):
        # view-data-parallel: the same view batch over n cards and one
        dp = jax.jit(functools.partial(dp_train_step, img_w=W, img_h=H,
                                       settings=settings),
                     static_argnums=(4,))
        runs = {}
        for label, m in (("1", mesh1), ("n", mesh)):
            s, o, met = dp(scene, opt, cam_batch, targets, m)
            jax.block_until_ready(s)
            runs[label] = (s, met)
        compare(f"dp x{n_cards}", runs["1"], runs["n"])

        # gaussian-sharded step on one view vs the one-card step: with the
        # exact f32 entry exchange the update must match; the f16 exchange
        # (the default) rounds the splat attributes it sends, so only the
        # loss is held to the f16 class there
        s1, _, m1 = train_step(scene, opt, cams[0], targets[0], img_w=W,
                               img_h=H, settings=settings)
        for exchange_f16 in (False, True):
            sx = dataclasses.replace(settings, exchange_f16=exchange_f16)
            gs = jax.jit(functools.partial(gs_train_step, img_w=W, img_h=H,
                                           settings=sx),
                         static_argnums=(4,))
            sn, on, mn = gs(scene, opt, cams[0], targets[0], mesh)
            check(int(mn["entries_dropped"]) == 0, "gs step dropped entries")
            label = f"gs x{n_cards} f{16 if exchange_f16 else 32} exchange"
            if exchange_f16:
                dl = abs(float(mn["loss"]) / float(m1["loss"]) - 1.0)
                print(f"  {label}: loss rel diff vs one card {dl:.2e} (tol "
                      f"{TOL_LOSS_REL_F16:g})", flush=True)
                check(dl <= TOL_LOSS_REL_F16, f"{label}: loss differs {dl}")
            else:
                compare(label, (s1, m1), (sn, mn))
            # the step's outputs come back sharded: the first call on them
            # compiles again, so it stays out of the timing
            sn, on, mn = gs(sn, on, cams[0], targets[0], mesh)
            jax.block_until_ready(sn)
            t0 = time.perf_counter()
            for _ in range(3):
                sn, on, mn = gs(sn, on, cams[0], targets[0], mesh)
            jax.block_until_ready(sn)
            print(f"  {label}: {(time.perf_counter() - t0) / 3 * 1e3:.1f} "
                  "ms/step", flush=True)
        del runs, s, o, s1, sn
        jax.clear_caches()

        # the user-facing loops
        fy = 0.5 * H / np.tan(np.radians(45.0) / 2)
        cam_data = [CameraData(id=i, position=np.asarray(p, np.float32),
                               rotation=np.eye(3, dtype=np.float32), fx=fy,
                               fy=fy, width=W, height=H, img_name=f"v{i}")
                    for i, p in enumerate(positions)]
        images = [{"name": f"v{i}", "image": np.asarray(t), "width": W,
                   "height": H} for i, t in enumerate(targets)]
        no_densify = TrainerConfig(densify=DensifyPruneConfig(
            schedule=DensifySchedule(enabled=False)))
        for label, trainer in (
                ("Trainer(mesh) dp", Trainer(scene, cam_data, images,
                                             no_densify, settings,
                                             mesh=mesh)),
                ("GsTrainer", GsTrainer(scene, cam_data, images,
                                        TrainerConfig(densify=DensifyPruneConfig(
                                            schedule=DensifySchedule(
                                                warmup_iterations=2,
                                                interval=2,
                                                stop_iterations=4),
                                            metric_views=n_cards,
                                            clone_threshold_count=10)),
                                        settings, mesh=mesh))):
            events = []
            densify = type(trainer)._run_densify

            def record_densify(tr, w, h):
                densify(tr, w, h)
                events.append((tr.iteration, tr.num_points))

            t0 = time.perf_counter()
            with mock.patch.object(type(trainer), "_run_densify",
                                   record_densify):
                losses = [float(trainer.step()["loss"]) for _ in range(4)]
            print(f"  {label}: 4 steps in {time.perf_counter() - t0:.1f} s "
                  f"incl. compiles; losses "
                  + ", ".join(f"{x:.5f}" for x in losses)
                  + f"; densify events (iteration, points) {events}",
                  flush=True)
            check(all(np.isfinite(losses)), f"{label}: non-finite loss")
        check(events, "GsTrainer ran no densify event")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the multi-card phase on 4 cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import webdgs  # noqa: F401  (fails outside a checkout)
    import jax

    from webdgs.config import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX runs on {dev.platform}", file=sys.stderr)
        return 1
    phase = Phases(card_line())
    with phase("device"):
        print(f"  {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
              f"jax {jax.__version__}", flush=True)

    if args.cards > 1:
        phase_multicard(phase, args.cards)
    else:
        phase_kernels(phase)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            ply = phase_train(phase, work)
            phase_view_serve(phase, work, ply)
        phase_scale(phase)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
