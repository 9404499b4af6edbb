"""Global runtime configuration.

The reference keeps its render settings in a `RenderSettings` uniform
(reference: src/shaders/common.wgsl:10-18, defaults at
src/renderers/tiled-forward-pass.ts:174-182).  We mirror those defaults here
as a frozen dataclass that is threaded through the render/train functions.
"""

from __future__ import annotations

import dataclasses
import os

import jax


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render settings (shapes/behavior of the compiled pipeline).

    Mirrors the reference's RenderSettings uniform defaults
    (src/renderers/tiled-forward-pass.ts:174-182):
      gaussian_scaling=1.0, point_size_px=3.0, gaussian_mode=1 ('gaussian'),
      max_splat_radius_px=128.0; tile 16x16
      (src/renderers/tiled-forward-pass.ts:18-19).
    """

    # Tile size is an execution parameter, not a semantics one: the final
    # image is identical for any tiling (pixel contributions are decided
    # by the per-splat extent/alpha tests, not by tile membership).  The
    # reference uses 16x16 (tiled-forward-pass.ts:18-19), which also
    # measured fastest for the train step on an H100 (PERF.md).
    # tile_w*tile_h and chunk must be powers of two (the kernel's block
    # shape).
    tile_w: int = 16
    tile_h: int = 16
    # Splat-size multiplier — the reference's "Gaussian scale" slider
    # (index.html:246, main.ts:369-372).  Its tiled path declares but never
    # reads the uniform; here it multiplies the decoded stddev.
    gaussian_scaling: float = 1.0
    # Screen-space radius cap in pixels; <=0 disables (reference default 128).
    max_splat_radius_px: float = 128.0
    # Reference enforces <=2048 tiles touched per Gaussian
    # (src/shaders/tiled-forward.wgsl:275).
    max_tiles_per_gaussian: int = 2048
    # Sizing heuristic for the padded tile-entry capacity: avg tiles/Gaussian.
    # The reference budgets 30 (src/renderers/tiled-forward-pass.ts:137); we
    # default to 12 because every O(capacity) op (sort, gathers, kernels)
    # pays for the padding, and trained scenes average well below this.
    # Gaussians beyond the budget are dropped whole for that frame.
    avg_tiles_per_gaussian: int = 12
    # Hard cap on tile entries, like the reference's 128MB key-buffer /
    # prefix-sum limits (src/renderers/tiled-forward-pass.ts:147-152).
    max_tile_entries: int = 2 ** 25  # 32M entries
    # Background color composited behind the splats
    # (src/shaders/tiled-rasterizer.wgsl:58: black).
    background: tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Entries per chunk: the column count of the rasterizer kernels'
    # (pixel, entry) block, which lives in registers (PERF.md: 16 beat
    # 32 and 64 for the train step on an H100).
    chunk: int = 16
    # Early-termination transmittance threshold. The reference skips a splat
    # once accumulated alpha exceeds 0.99 (tiled-rasterizer.wgsl:224), i.e.
    # T < 0.01.
    t_threshold: float = 0.01
    # Minimum alpha for a splat to contribute; the reference uses 1/255 for
    # contributor tracking and backward skipping
    # (tiled-rasterizer.wgsl:238, tiled-backward-rasterize.wgsl:116).
    alpha_min: float = 1.0 / 255.0
    # Alpha clamp (tiled-rasterizer.wgsl:233).
    alpha_max: float = 0.99
    # Cull (gaussian, tile) pairs whose maximum alpha over the tile's pixel
    # box is provably < alpha_min (exact convex-quadratic min over the box,
    # conservatively rounded).  The rasterizer's alpha_min mask already
    # zeroes every pixel of such pairs, so the image and gradients are
    # unchanged; the reference's SnugBox rect binning
    # (tiled-forward.wgsl:298-354) over-covers by ~24% at the bench scene
    # and every O(entries) stage (sort, gathers, kernels, adaptive
    # capacity) shrinks with the cull.  Off = reference-exact rect binning.
    # Epsilon-class assumption: the cull's conservatism margins
    # (qthr*(1+1e-5)+1e-4, qmin*(1-2^-12), 1e-3 px extent slack;
    # ops/binning.py:_cull_bitmask) are empirical slack against the
    # kernel's independently-rounded f32 alpha evaluation, not derived
    # error bounds — a pair whose max alpha sits within ~2^-12 of
    # alpha_min could in principle be culled while the kernel would have
    # kept it at one pixel (an alpha_min-scale contribution).  A
    # randomized sweep of opacities through the alpha_min boundary
    # (tests/test_binning.py::test_tile_cull_image_identical_near_threshold)
    # empirically bounds the margin: no discrepancy observed.
    tile_cull: bool = True
    # Exchange packed entry rows as f16 in the gaussian-sharded
    # paths (halves all_to_all bytes: 32B -> 16B per entry + 4B key).
    # Centers are encoded tile-relative before the cast so the f16 mantissa
    # covers sub-pixel detail at any frame size — the same f16 class the
    # reference stores ALL its splat attributes in
    # (src/utils/load-pointcloud.ts:5-12, update-gaussians.wgsl).
    exchange_f16: bool = True

    @property
    def tile_px(self) -> int:
        return self.tile_w * self.tile_h


DEFAULT_SETTINGS = RenderSettings()


def quantize_budget(want: int | float, chunk: int, floor: int) -> int:
    """Round a capacity request UP to a coarse geometric ladder (~8 rungs
    per octave), in ``chunk`` multiples.

    Every distinct value of a static budget is a separate XLA compilation,
    so a budget that tracks a steadily-growing
    observation (entry counts during densification, the viewer's per-frame
    capacity during live training) must move in rungs, not chunk steps —
    chunk-granular growth would retrigger a recompile at nearly every
    adaptation interval while the scene grows.  Rung spacing ~16% costs at
    most that much extra buffer over the exact request."""
    want = max(int(want), floor, chunk)
    g = max(1 << max(want.bit_length() - 3, 0), chunk)
    return -(-(-(-want // g) * g) // chunk) * chunk


# the persistent compile cache's fixed home inside the checkout (the path
# is part of the cache key, so it must not move between runs)
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache for this process.

    Entry points (CLI, bench, chip_smoke) call this so fresh processes
    reuse compiled executables.  Where ``JAX_COMPILATION_CACHE_DIR`` is set,
    JAX reads it itself and nothing is set here; otherwise the cache lives
    in ``.jax_cache/`` at the root of the checkout."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def use_interpret_mode(platform: str | None = None) -> bool:
    """Whether Pallas kernels run in interpreter mode: on the CPU (tests,
    virtual-device meshes) they do, on the GPU they compile.  Any other
    platform has no kernel route and raises."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas kernel route for platform {platform!r}: the kernels "
        "compile for the GPU and run interpreted on the CPU")
