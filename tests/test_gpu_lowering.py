"""Lower the compute paths for CUDA without a card.

``jax.export`` with ``platforms=['cuda']`` runs the Pallas -> Triton
lowering of every kernel on the path, so an operation the Triton route
cannot express (a static value slice, an unsupported primitive) fails here
on a CPU-only machine instead of on the card.  What only the card's
compiler can refuse (registers, shared memory) still needs ``pytest -m
gpu`` and ``chip_smoke.py`` on the card.
"""

import jax
import jax.export as jexp
import jax.numpy as jnp
import numpy as np
import pytest

TRITON_CALL = "__gpu$xla.gpu.triton"


@pytest.fixture()
def compiled_kernels(monkeypatch):
    """Lower the kernels as the GPU runs them, not interpreted."""
    from webdgs.ops import rasterize

    monkeypatch.setattr(rasterize, "use_interpret_mode", lambda: False)


def _scene(n, seed=0):
    from webdgs.core.scene import scene_from_arrays

    rng = np.random.default_rng(seed)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return scene_from_arrays(
        rng.normal(0, 1.5, (n, 3)).astype(np.float32), quats=quats,
        log_scales=rng.uniform(-4.5, -2.5, (n, 3)).astype(np.float32),
        opacity_logits=rng.uniform(-1, 3, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _export_cuda(fn, *args, kernels=1):
    exported = jexp.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[jexp.DisabledSafetyCheck.custom_call(TRITON_CALL)],
    )(*args)
    assert exported.platforms == ("cuda",)
    assert exported.mlir_module().count(TRITON_CALL) >= kernels
    return exported


def test_render_lowers_for_gpu(compiled_kernels):
    """Forward path: binning + the forward rasterizer kernel."""
    from webdgs.config import RenderSettings
    from webdgs.core.camera import default_camera
    from webdgs.render.renderer import render

    w = h = 128
    settings = RenderSettings()
    cam = default_camera(w, h, position=(0.0, 0.0, -8.0))
    _export_cuda(lambda s: render(s, cam, w, h, settings).image,
                 _scene(1024))


@pytest.mark.parametrize("chunk,tile_w,tile_h", [
    (16, 16, 16),  # default
    (32, 16, 16),
    (16, 32, 16),
])
def test_train_step_lowers_for_gpu(compiled_kernels, chunk, tile_w, tile_h):
    """Full step: forward + backward rasterizer kernels, image-space loss,
    packed Adam, at each tile/chunk shape the kernels were tuned over."""
    from webdgs.config import RenderSettings
    from webdgs.core.camera import default_camera
    from webdgs.ops.adam import init_adam_state
    from webdgs.train.step import train_step

    w = h = 128
    settings = RenderSettings(chunk=chunk, tile_w=tile_w, tile_h=tile_h)
    cam = default_camera(w, h, position=(0.0, 0.0, -8.0))
    scene = _scene(1024)
    target = jnp.zeros((h, w, 3), jnp.float32)
    opt = init_adam_state(scene.params())

    def step(s, o):
        r = train_step(s, o, cam, target, img_w=w, img_h=h,
                       settings=settings, entry_capacity=4096)
        return r.scene.means, r.metrics["loss"]

    _export_cuda(step, scene, opt, kernels=2)


def test_band_sharded_step_lowers_for_gpu(compiled_kernels):
    """The gaussian-sharded training step (entry exchange, band-local loss
    with halo ppermutes) on a 4-device mesh."""
    from webdgs.config import RenderSettings
    from webdgs.core.camera import default_camera
    from webdgs.ops.adam import init_adam_state
    from webdgs.parallel.sharding import gs_train_step, make_mesh

    mesh = make_mesh(jax.devices()[:4])
    w = h = 64
    settings = RenderSettings()
    cam = default_camera(w, h, position=(0.0, 0.0, -8.0))
    scene = _scene(512)
    opt = init_adam_state(scene.params())
    target = jnp.zeros((h, w, 3), jnp.float32)

    def step(s, o):
        s2, _, m = gs_train_step(s, o, cam, target, mesh, img_w=w, img_h=h,
                                 settings=settings)
        return s2.means, m["loss"]

    _export_cuda(step, scene, opt, kernels=2)


def test_importance_lowers_for_gpu(compiled_kernels):
    """Densify metric path: forward kernel + per-entry replay."""
    from webdgs.config import RenderSettings
    from webdgs.core.camera import default_camera
    from webdgs.ops.importance import view_importance_counts

    w = h = 64
    settings = RenderSettings()
    cam = default_camera(w, h, position=(0.0, 0.0, -8.0))
    scene = _scene(512)
    target = jnp.zeros((h, w, 3), jnp.float32)

    def counts(params, alive):
        return view_importance_counts(params, alive, scene.sh_deg, cam,
                                      target, w, h, 0.5, settings)

    _export_cuda(counts, scene.params(), scene.alive)
