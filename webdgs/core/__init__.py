from webdgs.core.camera import Camera, CameraData, make_camera
from webdgs.core.scene import GaussianScene

__all__ = ["Camera", "CameraData", "make_camera", "GaussianScene"]
