"""Proxy-mesh geometry: OBJ loading, object posing, ray-traced depth render."""

from signerf_tpu_torch.geometry.obj import load_obj
from signerf_tpu_torch.geometry.raster import mesh_depth_render

__all__ = ["load_obj", "mesh_depth_render"]
