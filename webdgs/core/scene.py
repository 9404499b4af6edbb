"""The Gaussian scene pytree.

The reference stores the scene as packed f16 buffers (24B Gaussian + 96B SH
per point, src/utils/load-pointcloud.ts:5-12,214-218) plus separate f32
optimizer master copies that are re-packed to f16 every step
(src/shaders/update-gaussians.wgsl).  Here we keep one f32 source of truth
— the pack/unpack machinery collapses away entirely.

Parameterization matches the reference exactly:
  * ``quats``: (w, x, y, z), not necessarily normalized
    (src/shaders/densify-prune-scatter-gaussians.wgsl:60).
  * ``log_scales``: log-space, decoded with exp
    (src/shaders/tiled-forward.wgsl:179).
  * ``opacity_logits``: sigmoid-space logit (tiled-forward.wgsl:185).
  * ``sh``: (N, 16, 3) interleaved-RGB-per-coefficient, DC first
    (tiled-forward.wgsl:64-86; load-pointcloud.ts:184-192).

Densify/prune changes the point count at runtime; XLA wants static shapes, so
the scene is capacity-padded with an ``alive`` mask.  Dead slots have
``alive == False`` and are culled in projection.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

SH_C0 = 0.28209479177387814


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["means", "quats", "log_scales", "opacity_logits", "sh",
                 "alive"],
    meta_fields=["sh_deg"])
@dataclasses.dataclass(frozen=True)
class GaussianScene:
    means: jax.Array  # (N, 3) f32
    quats: jax.Array  # (N, 4) f32, (w, x, y, z)
    log_scales: jax.Array  # (N, 3) f32
    opacity_logits: jax.Array  # (N,) f32
    sh: jax.Array  # (N, 16, 3) f32
    alive: jax.Array  # (N,) bool
    sh_deg: int = 0

    def replace(self, **updates) -> "GaussianScene":
        return dataclasses.replace(self, **updates)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def num_alive(self) -> jax.Array:
        return jnp.sum(self.alive.astype(jnp.int32))

    def pad_to(self, capacity: int) -> "GaussianScene":
        """Grow the capacity, with dead padding slots."""
        n = self.capacity
        if capacity < n:
            raise ValueError(f"cannot shrink capacity {n} -> {capacity}")
        if capacity == n:
            return self
        pad = capacity - n

        def pad_leaf(x):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)

        return GaussianScene(
            means=pad_leaf(self.means),
            quats=pad_leaf(self.quats),
            log_scales=pad_leaf(self.log_scales),
            opacity_logits=pad_leaf(self.opacity_logits),
            sh=pad_leaf(self.sh),
            alive=jnp.concatenate(
                [self.alive, jnp.zeros((pad,), dtype=bool)]),
            sh_deg=self.sh_deg,
        )

    def params(self) -> dict[str, jax.Array]:
        """The trainable-parameter subtree."""
        return {
            "means": self.means,
            "quats": self.quats,
            "log_scales": self.log_scales,
            "opacity_logits": self.opacity_logits,
            "sh": self.sh,
        }

    def with_params(self, params: dict[str, jax.Array]) -> "GaussianScene":
        return self.replace(
            means=params["means"],
            quats=params["quats"],
            log_scales=params["log_scales"],
            opacity_logits=params["opacity_logits"],
            sh=params["sh"],
        )


def scene_from_arrays(
    means: np.ndarray,
    quats: np.ndarray | None = None,
    log_scales: np.ndarray | None = None,
    opacity_logits: np.ndarray | None = None,
    sh: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    sh_deg: int = 0,
    capacity: int | None = None,
) -> GaussianScene:
    """Build a scene; fills 'normal' point-cloud defaults like the reference.

    A plain point cloud (xyz + rgb) becomes Gaussians with opacity_logit=1,
    quat=(1,0,0,0), log_scale=-5 and SH DC = (c - 0.5)/C0
    (src/utils/load-pointcloud.ts:256-288).
    """
    n = means.shape[0]
    means = np.asarray(means, dtype=np.float32)
    if quats is None:
        quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    if log_scales is None:
        log_scales = np.full((n, 3), -5.0, dtype=np.float32)
    if opacity_logits is None:
        opacity_logits = np.full((n,), 1.0, dtype=np.float32)
    if sh is None:
        sh = np.zeros((n, 16, 3), dtype=np.float32)
        if colors is not None:
            sh[:, 0, :] = (np.asarray(colors, np.float32) - 0.5) / SH_C0
    alive = np.ones((n,), dtype=bool)

    scene = GaussianScene(
        means=jnp.asarray(means),
        quats=jnp.asarray(np.asarray(quats, np.float32)),
        log_scales=jnp.asarray(np.asarray(log_scales, np.float32)),
        opacity_logits=jnp.asarray(np.asarray(opacity_logits, np.float32)),
        sh=jnp.asarray(np.asarray(sh, np.float32)),
        alive=jnp.asarray(alive),
        sh_deg=int(sh_deg),
    )
    if capacity is not None and capacity > n:
        scene = scene.pad_to(capacity)
    return scene


def tree_size_bytes(tree: Any) -> int:
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))
