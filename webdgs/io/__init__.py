from webdgs.io.colmap import load_cameras
from webdgs.io.images import load_images
from webdgs.io.ply import load_point_cloud, save_ply

__all__ = ["load_cameras", "load_images", "load_point_cloud", "save_ply"]
