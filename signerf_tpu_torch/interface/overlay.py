"""3D scene overlays for the built-in viewer: wireframe projection and line
rasterization on the host (numpy), composited onto NeRF renders.

A copy of `signerf_tpu/interface/overlay.py` (numpy only, so the port keeps
its own): train-camera frustums, the reference cameras and their ring, the
selection AABB and the proxy mesh's wire, drawn over the orbit render, and
the screen-space drag of a handle in the camera plane.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Segments = np.ndarray  # [K, 2, 3] world-space line segments

# overlay palette (RGB in [0,1])
COLOR_TRAIN = (0.25, 0.55, 1.0)  # train-camera frustums: blue
COLOR_REFERENCE = (1.0, 0.6, 0.1)  # reference cameras + circle: orange
COLOR_SYNTHETIC = (0.2, 0.9, 0.4)  # synthetic dataset cameras: green
COLOR_AABB = (1.0, 0.95, 0.2)  # selection box: yellow
COLOR_SHAPE = (0.95, 0.3, 0.9)  # proxy mesh wire: magenta


# ---------------------------------------------------------------------------
# world-space wireframe builders
# ---------------------------------------------------------------------------


def camera_frustum_segments(
    c2w: np.ndarray, scale: float = 0.08, aspect: float = 1.0
) -> Segments:
    """Wireframe pyramid for one camera pose [3,4] (OpenGL: -z forward)."""
    o = c2w[:3, 3]
    R = c2w[:3, :3]
    # image-plane corners at unit depth, fov ~53 deg
    hw, hh = 0.5 * scale, 0.5 * scale / max(aspect, 1e-6)
    corners_cam = np.array(
        [
            [-hw, -hh, -scale],
            [hw, -hh, -scale],
            [hw, hh, -scale],
            [-hw, hh, -scale],
        ]
    )
    corners = corners_cam @ R.T + o
    segs = []
    for i in range(4):
        segs.append([o, corners[i]])  # apex -> corner
        segs.append([corners[i], corners[(i + 1) % 4]])  # rim
    # "up" tick on the top edge so orientation is readable
    top_mid = 0.5 * (corners[2] + corners[3])
    up_tick = top_mid + R[:, 1] * 0.3 * scale
    segs.append([top_mid, up_tick])
    return np.asarray(segs)


def frustums_for_poses(poses: np.ndarray, scale: float = 0.08) -> Segments:
    """[N,3,4] poses -> concatenated frustum segments."""
    if poses is None or len(poses) == 0:
        return np.zeros((0, 2, 3))
    return np.concatenate(
        [camera_frustum_segments(np.asarray(p), scale) for p in poses]
    )


def polyline_segments(points: np.ndarray, closed: bool = True) -> Segments:
    """Connect consecutive points (e.g. the reference-camera circle)."""
    pts = np.asarray(points)
    if len(pts) < 2:
        return np.zeros((0, 2, 3))
    nxt = np.roll(pts, -1, axis=0)
    segs = np.stack([pts, nxt], axis=1)
    return segs if closed else segs[:-1]


def aabb_segments(aabb_min, aabb_max) -> Segments:
    """12 edges of the selection box."""
    lo = np.asarray(aabb_min, np.float64)
    hi = np.asarray(aabb_max, np.float64)
    c = np.array(
        [
            [x, y, z]
            for x in (lo[0], hi[0])
            for y in (lo[1], hi[1])
            for z in (lo[2], hi[2])
        ]
    )  # [8, 3], index bit order (x, y, z)
    edges = [
        (0, 1), (2, 3), (4, 5), (6, 7),  # z edges
        (0, 2), (1, 3), (4, 6), (5, 7),  # y edges
        (0, 4), (1, 5), (2, 6), (3, 7),  # x edges
    ]
    return np.asarray([[c[a], c[b]] for a, b in edges])


def mesh_wire_segments(
    verts: np.ndarray, faces: np.ndarray, max_edges: int = 600
) -> Segments:
    """Subsampled triangle edges of the proxy mesh (enough to read the
    silhouette without rasterizing thousands of lines)."""
    if len(faces) == 0:
        return np.zeros((0, 2, 3))
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    e = np.unique(np.sort(e, axis=1), axis=0)
    if len(e) > max_edges:
        idx = np.linspace(0, len(e) - 1, max_edges).astype(int)
        e = e[idx]
    return np.stack([verts[e[:, 0]], verts[e[:, 1]]], axis=1)


# ---------------------------------------------------------------------------
# projection + rasterization
# ---------------------------------------------------------------------------


def project_points(
    pts: np.ndarray,
    c2w: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """World points [N,3] -> (pixel xy [N,2], depth>0-in-front [N]).

    Matches cameras.py's OpenGL convention (-z forward, image y down):
    px = cx + fx * xc / -zc, py = cy - fy * yc / -zc.
    """
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    pc = (np.asarray(pts, np.float64) - t) @ R  # R^T (p - t)
    depth = -pc[:, 2]
    safe = np.maximum(depth, 1e-9)
    px = cx + fx * pc[:, 0] / safe
    py = cy - fy * pc[:, 1] / safe
    return np.stack([px, py], axis=1), depth


def draw_segments(
    img: np.ndarray,
    segs: Segments,
    color: Tuple[float, float, float],
    c2w: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    alpha: float = 0.9,
) -> np.ndarray:
    """Rasterize world segments onto img [H,W,3] float in [0,1], in place."""
    if len(segs) == 0:
        return img
    h, w = img.shape[:2]
    p0, d0 = project_points(segs[:, 0], c2w, fx, fy, cx, cy)
    p1, d1 = project_points(segs[:, 1], c2w, fx, fy, cx, cy)
    vis = (d0 > 1e-6) & (d1 > 1e-6)  # drop segments behind the camera
    p0, p1 = p0[vis], p1[vis]
    if len(p0) == 0:
        return img
    # sample each segment at ~1px spacing
    lengths = np.linalg.norm(p1 - p0, axis=1)
    n_samp = np.clip(lengths.astype(int) + 1, 2, 4 * max(h, w))
    col = np.asarray(color)
    for a, b, n in zip(p0, p1, n_samp):
        ts = np.linspace(0.0, 1.0, n)[:, None]
        xy = a[None] + (b - a)[None] * ts
        xs = np.round(xy[:, 0]).astype(int)
        ys = np.round(xy[:, 1]).astype(int)
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        xs, ys = xs[keep], ys[keep]
        img[ys, xs] = (1 - alpha) * img[ys, xs] + alpha * col
    return img


# ---------------------------------------------------------------------------
# scene composition
# ---------------------------------------------------------------------------


def compose_overlays(
    rgb: np.ndarray,
    cam: Dict[str, float],  # {c2w [3,4], fx, fy, cx, cy}
    scene: Dict[str, object],
    show: Dict[str, bool],
) -> np.ndarray:
    """Draw the requested scene elements over a rendered frame.

    ``scene`` comes from GenerationInterface.scene_elements():
      train_poses [N,3,4] | None, reference_poses, synthetic_poses,
      aabb (min,max) | None, shape {verts, faces} | None.
    ``show`` keys: train, reference, synthetic, aabb, shape.
    """
    img = np.array(rgb, np.float32, copy=True)
    c2w = np.asarray(cam["c2w"])
    args = (c2w, cam["fx"], cam["fy"], cam["cx"], cam["cy"])

    if show.get("train") and scene.get("train_poses") is not None:
        segs = frustums_for_poses(np.asarray(scene["train_poses"]), scale=0.07)
        draw_segments(img, segs, COLOR_TRAIN, *args, alpha=0.6)
    if show.get("synthetic") and scene.get("synthetic_poses") is not None:
        segs = frustums_for_poses(
            np.asarray(scene["synthetic_poses"]), scale=0.07
        )
        draw_segments(img, segs, COLOR_SYNTHETIC, *args, alpha=0.6)
    if show.get("reference") and scene.get("reference_poses") is not None:
        poses = np.asarray(scene["reference_poses"])
        segs = frustums_for_poses(poses, scale=0.1)
        draw_segments(img, segs, COLOR_REFERENCE, *args)
        ring = polyline_segments(poses[:, :3, 3], closed=True)
        draw_segments(img, ring, COLOR_REFERENCE, *args, alpha=0.5)
    if show.get("aabb") and scene.get("aabb") is not None:
        lo, hi = scene["aabb"]
        draw_segments(img, aabb_segments(lo, hi), COLOR_AABB, *args)
    if show.get("shape") and scene.get("shape") is not None:
        sh = scene["shape"]
        segs = mesh_wire_segments(
            np.asarray(sh["verts"]), np.asarray(sh["faces"])
        )
        draw_segments(img, segs, COLOR_SHAPE, *args, alpha=0.7)
    return np.clip(img, 0.0, 1.0)


def pixel_drag_to_world(
    dx_px: float,
    dy_px: float,
    c2w: np.ndarray,
    fx: float,
    fy: float,
    point: np.ndarray,
) -> np.ndarray:
    """Convert a screen-space drag into a camera-plane world translation of
    ``point`` (the gizmo behavior: dragging moves the handle in the plane
    parallel to the image through the handle)."""
    c2w = np.asarray(c2w)
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    depth = float(-( (np.asarray(point) - t) @ R )[2])
    depth = max(depth, 1e-6)
    right = R[:, 0]
    up = R[:, 1]
    # image y is down: +dy_px moves the point along -up
    return right * (dx_px * depth / fx) - up * (dy_px * depth / fy)
