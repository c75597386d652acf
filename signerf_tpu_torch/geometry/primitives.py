"""Procedural proxy meshes (default shape-guidance assets), numpy only.

A copy of `signerf_tpu/geometry/primitives.py` (the port imports nothing
of the JAX package): the same cube, icosphere and procedural bunny, vertex
for vertex, so both packages rasterize the same proxy. Any user OBJ loads
through `geometry.obj.load_obj`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def cube(size: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned cube centered at origin: (verts [8,3], faces [12,3])."""
    s = size / 2.0
    verts = np.array(
        [
            [-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
            [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
        ],
        np.float32,
    )
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom (-z)
            [4, 5, 6], [4, 6, 7],  # top (+z)
            [0, 1, 5], [0, 5, 4],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [1, 2, 6], [1, 6, 5],  # +x
            [3, 0, 4], [3, 4, 7],  # -x
        ],
        np.int32,
    )
    return verts, faces


def icosphere(subdivisions: int = 2, radius: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron: (verts [V,3], faces [F,3])."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts = verts / np.linalg.norm(verts, axis=-1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (vlist[a] + vlist[b]) / 2.0
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def bunny(subdivisions: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural bunny-shaped proxy mesh (triangle soup of deformed
    icosphere parts: body, head, two ears, tail).

    Fills the role of the reference's default proxy asset
    (`models/bunny.obj` of the reference renderer)
    without copying it: shape-mode masking only needs a default surface with
    a recognizable, asymmetric silhouette to rasterize into the depth
    condition. Unit-scale, y-up, sitting on y=0, nose toward +x.
    """

    def part(center, radii, sub):
        v, f = icosphere(sub, 1.0)
        v = v * np.asarray(radii, np.float64) + np.asarray(center, np.float64)
        return v, f

    specs = [
        ((0.00, 0.36, 0.00), (0.34, 0.36, 0.28), subdivisions),  # body
        ((0.26, 0.74, 0.00), (0.19, 0.17, 0.15), subdivisions),  # head
        ((0.42, 0.70, 0.00), (0.07, 0.05, 0.05), subdivisions - 1),  # nose
        ((0.20, 1.02, 0.08), (0.055, 0.20, 0.035), subdivisions - 1),  # ear
        ((0.20, 1.02, -0.08), (0.055, 0.20, 0.035), subdivisions - 1),  # ear
        ((-0.32, 0.28, 0.00), (0.09, 0.09, 0.09), subdivisions - 1),  # tail
        ((0.16, 0.10, 0.14), (0.14, 0.09, 0.08), subdivisions - 1),  # paw
        ((0.16, 0.10, -0.14), (0.14, 0.09, 0.08), subdivisions - 1),  # paw
    ]
    all_v, all_f, offset = [], [], 0
    for center, radii, sub in specs:
        v, f = part(center, radii, max(1, sub))
        all_v.append(v)
        all_f.append(f.astype(np.int64) + offset)
        offset += len(v)
    verts = np.concatenate(all_v).astype(np.float32)
    faces = np.concatenate(all_f).astype(np.int32)
    return verts, faces


def save_obj(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write (verts, faces) as a minimal OBJ (v/f records)."""
    with open(path, "w") as fh:
        fh.write("# generated by signerf_tpu_torch.geometry.primitives\n")
        for v in verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
