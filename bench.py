"""Headline benchmark: training iterations/second and rendered Mpix/s on
one GPU.

Scene: 100k random Gaussians at 800x600, full step (projection + binning +
rasterizer forward/backward + loss + gated Adam) at the adaptive entry
capacity the Trainer settles on, then forward-only frames at the same
capacity.  Prints the device (platform, kind, count) and the card's power
limit, then one JSON line.

    python bench.py              # on the GPU; fails without one
    python bench.py --cpu-smoke  # toy shapes on the CPU (code-path check)
"""

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np


def card_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="train + render benchmark")
    ap.add_argument("--cpu-smoke", action="store_true",
                    help="run toy shapes on the CPU; the metric says cpu")
    args = ap.parse_args(argv)

    import jax

    if args.cpu_smoke:
        jax.config.update("jax_platforms", "cpu")
    from webdgs.config import enable_compilation_cache
    enable_compilation_cache()
    dev = jax.devices()[0]
    if not args.cpu_smoke and dev.platform != "gpu":
        print(f"no GPU (JAX runs on {dev.platform}); pass --cpu-smoke for "
              "the toy CPU run", file=sys.stderr)
        raise SystemExit(1)
    card = "cpu" if args.cpu_smoke else card_power()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())};"
          f" card: {card}", flush=True)

    import jax.numpy as jnp

    from webdgs.config import RenderSettings, quantize_budget
    from webdgs.core.camera import default_camera
    from webdgs.core.scene import scene_from_arrays
    from webdgs.ops.adam import init_adam_state
    from webdgs.render.renderer import render_compiled
    from webdgs.train.step import train_step
    from webdgs.train.trainer import Trainer

    n = 500 if args.cpu_smoke else 100_000
    w, h = (128, 96) if args.cpu_smoke else (800, 600)
    rng = np.random.default_rng(0)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scene = scene_from_arrays(
        rng.normal(0, 1.5, (n, 3)).astype(np.float32),
        quats=quats,
        log_scales=rng.uniform(-4.5, -2.5, (n, 3)).astype(np.float32),
        opacity_logits=rng.uniform(-1, 3, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
    )
    settings = RenderSettings()
    cam = default_camera(w, h, position=(0.0, 0.0, -8.0))

    res = render_compiled(scene, cam, img_w=w, img_h=h, settings=settings)
    target = res.image
    cap = quantize_budget(
        int(res.binning.expansion_entries) * Trainer.ENTRY_CAP_HEADROOM,
        settings.chunk, settings.chunk * 8)
    opt = init_adam_state(scene.params())

    # donated, like the Trainer's step jit; the target is an argument (as
    # a captured constant XLA would fold its SSIM blurs at compile time)
    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(s, o, t):
        return train_step(s, o, cam, t, img_w=w, img_h=h,
                          settings=settings, entry_capacity=cap)

    s, o, _ = step(scene, opt, target)
    jax.block_until_ready(s)
    iters = 3 if args.cpu_smoke else 20
    t0 = time.perf_counter()
    for _ in range(iters):
        s, o, m = step(s, o, target)
    jax.block_until_ready(s)
    dt = (time.perf_counter() - t0) / iters

    img = render_compiled(s, cam, img_w=w, img_h=h, settings=settings,
                          entry_capacity=cap).image
    img.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        img = render_compiled(s, cam, img_w=w, img_h=h, settings=settings,
                              entry_capacity=cap).image
    img.block_until_ready()
    fdt = (time.perf_counter() - t0) / iters

    where = "cpu_smoke" if args.cpu_smoke else "1gpu"
    print(json.dumps({
        "metric": f"train_iters_per_sec_100k_splats_800x600_{where}",
        "value": 1.0 / dt,
        "unit": "iters/s",
        "render_mpix_per_sec": (w * h / 1e6) / fdt,
        "entry_capacity": cap,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
