"""webdgs — a differentiable 3D Gaussian Splatting framework for the GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of WebDGS
(krispy-kenay/WebDGS), a browser WebGPU 3DGS trainer/viewer.  The WGSL
compute pipeline of the reference maps here to:

* fused, vectorized JAX projection (EWA splatting, SH color, tile extents),
* `jax.lax.sort`-based tile/depth binning (replacing a hand-rolled radix
  sort + prefix scan),
* a Pallas-Triton tile rasterizer whose per-pixel front-to-back
  compositing is reformulated as log-transmittance prefix sums over
  (pixel, splat) blocks, with a custom VJP backward kernel,
* pure-JAX Adam / densify / prune with capacity-padded static shapes,
* `shard_map` view-parallel & tile-sharded execution over multi-card
  meshes.

See ARCHITECTURE.md for the design and SURVEY.md for the reference analysis.
"""

from webdgs.version import __version__


def __getattr__(name):
    """Lazy top-level API (keeps `import webdgs` free of jax startup)."""
    api = {
        "GaussianScene": ("webdgs.core.scene", "GaussianScene"),
        "Camera": ("webdgs.core.camera", "Camera"),
        "make_camera": ("webdgs.core.camera", "make_camera"),
        "RenderSettings": ("webdgs.config", "RenderSettings"),
        "render": ("webdgs.render.renderer", "render"),
        "Viewer": ("webdgs.render.viewer", "Viewer"),
        "Trainer": ("webdgs.train.trainer", "Trainer"),
        "TrainerConfig": ("webdgs.train.config", "TrainerConfig"),
        "load_point_cloud": ("webdgs.io.ply", "load_point_cloud"),
        "save_ply": ("webdgs.io.ply", "save_ply"),
        "load_cameras": ("webdgs.io.colmap", "load_cameras"),
        "load_images": ("webdgs.io.images", "load_images"),
    }
    if name in api:
        import importlib
        mod, attr = api[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'webdgs' has no attribute {name!r}")


__all__ = ["__version__", "GaussianScene", "Camera", "make_camera",
           "RenderSettings", "render", "Viewer", "Trainer", "TrainerConfig",
           "load_point_cloud", "save_ply", "load_cameras", "load_images"]
