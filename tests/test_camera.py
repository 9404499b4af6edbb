"""Camera math: the metric-viewport camera must equal an independently
constructed camera at that resolution (VERDICT round-1 item 8; reference
re-derives fovX at the smaller canvas, src/camera/camera.ts:138-146)."""

import numpy as np
import jax
import jax.numpy as jnp

from webdgs.core.camera import CameraData, make_camera


def _stacked(cam):
    return jax.tree.map(lambda x: x[None], cam)


def test_metric_camera_matches_independent_construction():
    from webdgs.train.trainer import Trainer

    rng = np.random.default_rng(3)
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    data = CameraData(position=np.array([0.3, -1.2, 2.0], np.float32),
                      rotation=rot.astype(np.float32),
                      width=641, height=479, fx=520.0, fy=510.0)

    w, h = 641, 479
    mw, mh = w // 2, h // 2  # 320 x 239 — aspect ratio NOT preserved

    full = make_camera(data, w, h)
    expected = make_camera(data, mw, mh)

    got = Trainer._metric_camera(None, _stacked(full), mw, mh)

    np.testing.assert_allclose(np.asarray(got.proj[0]),
                               np.asarray(expected.proj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.focal[0]),
                               np.asarray(expected.focal), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.viewport[0]),
                               np.asarray(expected.viewport), atol=0)
    np.testing.assert_allclose(np.asarray(got.view[0]),
                               np.asarray(expected.view), atol=0)


def test_metric_camera_projects_known_point_like_small_camera():
    """Project a world point through the metric camera and through a camera
    built directly at the metric resolution — identical pixel coordinates."""
    from webdgs.train.trainer import Trainer

    data = CameraData(position=np.zeros(3, np.float32),
                      rotation=np.eye(3, dtype=np.float32),
                      width=801, height=601, fx=700.0, fy=700.0)
    w, h = 801, 601
    mw, mh = w // 2, h // 2  # 400 x 300

    full = make_camera(data, w, h)
    small = make_camera(data, mw, mh)
    got = jax.tree.map(lambda x: x[0],
                       Trainer._metric_camera(None, _stacked(full), mw, mh))

    pt = jnp.array([0.4, -0.2, 3.0, 1.0], jnp.float32)

    def to_px(cam):
        clip = cam.proj @ (cam.view @ pt)
        ndc = clip[:2] / clip[3]
        vp = jnp.array([mw, mh], jnp.float32)
        return (ndc * jnp.array([0.5, -0.5]) + 0.5) * vp

    np.testing.assert_allclose(np.asarray(to_px(got)),
                               np.asarray(to_px(small)), rtol=0, atol=1e-4)
