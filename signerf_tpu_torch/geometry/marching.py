"""Iso-surface extraction by marching tetrahedra (vectorized numpy).

A copy of `signerf_tpu/geometry/marching.py` (numpy only, the same
vertices and faces). Every cube of the grid is cut into six tetrahedra
around its 0-6 diagonal; a tetrahedron with one or three corners inside
gives one triangle, with two a quad, so the cases are derived rather than
read from marching cubes' 256-entry tables, at the cost of about twice the
triangles. Vertices are shared by global grid-edge id, so the surface is
watertight wherever it does not leave the sampled volume.

The exported OBJ can serve as a shape-mode proxy (`renderer.object_path`):
edit a scene, export its mesh, and mask the next edit with it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Unit-cube corner offsets, indexed 0..7.
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.int64,
)

# Six tetrahedra around the 0-6 diagonal cover the cube.
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int64,
)

# Tet-local corner pairs for its 6 edges.
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _tet_case_triangles(case: int):
    """Triangles (as triples of tet-local edge indices) for one of the 16
    inside/outside configurations of a tetrahedron's 4 corners."""
    inside = [i for i in range(4) if case & (1 << i)]
    outside = [i for i in range(4) if not case & (1 << i)]

    def edge(a, b):
        return _TET_EDGES.index((min(a, b), max(a, b)))

    if len(inside) in (0, 4):
        return []
    if len(inside) == 1:
        a = inside[0]
        e = [edge(a, o) for o in outside]
        return [(e[0], e[1], e[2])]
    if len(inside) == 3:
        a = outside[0]
        e = [edge(a, i) for i in inside]
        return [(e[0], e[2], e[1])]
    # two inside (a, b), two outside (c, d): quad ac-ad-bd-bc
    a, b = inside
    c, d = outside
    ac, ad, bc, bd = edge(a, c), edge(a, d), edge(b, c), edge(b, d)
    return [(ac, ad, bd), (ac, bd, bc)]


_CASE_TRIS = [_tet_case_triangles(c) for c in range(16)]


def marching_tetrahedra(
    values: np.ndarray,  # [NX+1, NY+1, NZ+1] scalar field samples
    origin: np.ndarray,  # [3] world position of grid vertex (0,0,0)
    spacing: np.ndarray,  # [3] world step between grid vertices
    iso: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `field == iso` surface. Returns (vertices [V, 3] float32,
    faces [F, 3] int32). "Inside" = value > iso."""
    values = np.asarray(values, np.float64)
    origin = np.asarray(origin, np.float64)
    spacing = np.asarray(spacing, np.float64)
    nx, ny, nz = (np.array(values.shape) - 1).tolist()
    if min(nx, ny, nz) < 1:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # Global ids of every cube's 8 corners: [ncubes, 8]
    cx, cy, cz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    base = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)  # [C, 3]
    corner_xyz = base[:, None, :] + _CORNERS[None, :, :]  # [C, 8, 3]
    dims = np.array(values.shape)
    gid = (
        corner_xyz[..., 0] * dims[1] * dims[2]
        + corner_xyz[..., 1] * dims[2]
        + corner_xyz[..., 2]
    )  # [C, 8]
    vflat = values.ravel()

    edge_keys = []  # [M, 2] global vertex-id pairs, one per triangle corner
    tri_start = []
    for tet in _TETS:
        g = gid[:, tet]  # [C, 4]
        v = vflat[g]  # [C, 4]
        case = ((v > iso) << np.arange(4)).sum(axis=1)  # [C]
        for c in range(1, 15):
            tris = _CASE_TRIS[c]
            if not tris:
                continue
            sel = np.nonzero(case == c)[0]
            if sel.size == 0:
                continue
            gsel = g[sel]  # [S, 4]
            for tri in tris:
                for e in tri:
                    a, b = _TET_EDGES[e]
                    pair = np.stack([gsel[:, a], gsel[:, b]], axis=1)
                    pair.sort(axis=1)
                    edge_keys.append(pair)
    if not edge_keys:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    keys = np.concatenate(edge_keys, axis=0)  # [3*F, 2] in corner order

    # Dedup edges -> shared vertices (watertight across cube/tet borders).
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    va, vb = vflat[uniq[:, 0]], vflat[uniq[:, 1]]
    # interpolation parameter where the field crosses iso along the edge
    t = np.clip((iso - va) / np.where(vb == va, 1.0, vb - va), 0.0, 1.0)
    pa = np.stack(np.unravel_index(uniq[:, 0], values.shape), axis=1)
    pb = np.stack(np.unravel_index(uniq[:, 1], values.shape), axis=1)
    verts_grid = pa + (pb - pa) * t[:, None]
    verts = origin + verts_grid * spacing

    # `keys` was appended triangle-corner by triangle-corner, but grouped
    # per (tet, case, tri) blocks of S cubes each — rebuild faces in the
    # same blocked order.
    faces = []
    off = 0
    for pair in edge_keys:
        faces.append(inverse[off:off + pair.shape[0]])
        off += pair.shape[0]
    # every 3 consecutive blocks of equal length form the 3 corners of
    # `S` triangles
    tri_faces = []
    i = 0
    while i < len(faces):
        a, b, c = faces[i], faces[i + 1], faces[i + 2]
        tri_faces.append(np.stack([a, b, c], axis=1))
        i += 3
    faces_arr = np.concatenate(tri_faces, axis=0).astype(np.int32)

    # drop degenerate triangles (two corners on the same grid edge)
    keep = (
        (faces_arr[:, 0] != faces_arr[:, 1])
        & (faces_arr[:, 1] != faces_arr[:, 2])
        & (faces_arr[:, 0] != faces_arr[:, 2])
    )
    return verts.astype(np.float32), faces_arr[keep]


def save_obj(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """Minimal OBJ writer (v/f records, 1-indexed)."""
    with open(path, "w") as fh:
        for v in verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
