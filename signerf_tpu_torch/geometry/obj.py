"""Minimal OBJ mesh loader (vertices + triangulated faces) and object
posing, numpy only.

A copy of `signerf_tpu/geometry/obj.py`: `v` and `f` records, polygon fan
triangulation, negative and `v/vt/vn` index forms; the reference
renderer's object transform (XYZ Euler rotation, per-axis scale times the
nerfstudio/Blender ratio, translation).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np


def load_obj(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (vertices [V, 3] float32, faces [F, 3] int32)."""
    verts = []
    faces = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts:
        raise ValueError(f"no vertices found in {path}")
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
    )


NERFSTUDIO_BLENDER_SCALE_RATIO: float = 10.0


def object_pose_matrix(
    position, rotation_deg, scale, blender_scale_ratio: float = NERFSTUDIO_BLENDER_SCALE_RATIO
) -> np.ndarray:
    """Build the object transform used by the reference renderer
    (renderer.py:82-116): XYZ-Euler rotation (Rz@Ry@Rx), per-axis scale
    multiplied by the nerfstudio/Blender ratio (x10), then translation.

    The reference additionally left-multiplies BOTH the object pose and the
    camera pose by a Blender->OpenGL rotation (renderer.py:134-146); since
    the same rigid rotation is applied to both, it cancels in the relative
    transform, so we omit it and work directly in nerfstudio world space.
    """
    rx, ry, rz = np.radians(np.asarray(rotation_deg, np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx
    S = np.diag(np.asarray(scale, np.float64) * blender_scale_ratio)
    pose = np.eye(4)
    pose[:3, :3] = R @ S
    pose[:3, 3] = np.asarray(position, np.float64)
    return pose.astype(np.float32)


def transform_vertices(verts: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to [V, 3] vertices."""
    return (verts @ pose[:3, :3].T) + pose[:3, 3]
