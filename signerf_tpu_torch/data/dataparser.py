"""transforms.json parsing with the SIGNeRF schema extensions.

Port of `signerf_tpu/data/dataparser.py`: the parsing and the pose helpers
are numpy and unchanged; only `Cameras` is the port's. Image sizes come from
transforms.json's `w`/`h` or from the PNG header, so nothing here decodes an
image or needs Pillow. Schema rules kept from the reference:

  * fixed (top-level) or per-frame intrinsics `fl_x/fl_y/cx/cy/w/h` and
    OpenCV distortion `k1..k4, p1, p2`;
  * `scene_transform_matrix` preferred over `transform_matrix`;
  * `_mask_path`, with white masks for generated frames not listed in
    `original_indices`, and masks dropped unless the dataset has
    `original_indices`;
  * stored `original_transform_matrix` / `original_scale_factor` reused
    instead of re-orienting and rescaling;
  * no train/eval split;
  * auto-downscale so the larger side is under 1600 px, with the
    `images_{k}/` folder convention.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path, PurePath
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.utils.images import png_dims, save_array_png

MAX_AUTO_RESOLUTION = 1600


# ---------------------------------------------------------------------------
# pose orientation / centering (nerfstudio semantics, numpy)
# ---------------------------------------------------------------------------


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-8:
        return np.eye(3) if c > 0 else -np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def _focus_of_attention(poses: np.ndarray) -> np.ndarray:
    """Point minimizing distance to all camera optical axes (-z rays)."""
    dirs = -poses[:, :3, 2:3]
    origins = poses[:, :3, 3:4]
    m = np.eye(3)[None] - dirs @ np.transpose(dirs, (0, 2, 1))
    mt_m = np.transpose(m, (0, 2, 1)) @ m
    return np.linalg.solve(mt_m.sum(0), (mt_m @ origins).sum(0)).squeeze(-1)


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
) -> Tuple[np.ndarray, np.ndarray]:
    """Orient/center [N, 4, 4] c2w poses -> (new_poses [N, 4, 4], transform [3, 4])
    (nerfstudio `camera_utils.auto_orient_and_center_poses`)."""
    origins = poses[:, :3, 3]
    mean_origin = origins.mean(0)
    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = _focus_of_attention(poses)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unknown center_method {center_method!r}")

    if method == "up":
        up = poses[:, :3, 1].mean(0)
        rot = _rotation_between(up / np.linalg.norm(up), np.array([0.0, 0.0, 1.0]))
    elif method == "vertical":
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        _, _, vh = np.linalg.svd(poses[:, :3, 0], full_matrices=False)
        up_vertical = vh[2, :] if np.dot(vh[2, :], up) > 0 else -vh[2, :]
        rot = _rotation_between(up_vertical, np.array([0.0, 0.0, 1.0]))
    elif method == "pca":
        _, _, vh = np.linalg.svd(origins - mean_origin, full_matrices=False)
        rot = vh
        if np.linalg.det(rot) < 0:
            rot[2, :] *= -1
        if (rot @ poses[0, :3, 1])[2] < 0:
            rot = np.diag([1.0, -1.0, -1.0]) @ rot
    elif method == "none":
        rot = np.eye(3)
    else:
        raise ValueError(f"unknown orientation method {method!r}")

    transform = np.concatenate([rot, rot @ -translation[:, None]], axis=1)  # [3, 4]
    return np.einsum("ij,njk->nik", _to44(transform), poses), transform


def _to44(m34: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=m34.dtype)
    out[:3, :4] = m34
    return out


def transform_poses_to_original_space(
    poses: np.ndarray, applied_transform: np.ndarray, applied_scale: float
) -> np.ndarray:
    """Undo the dataparser's transform and scale: scene-space [N, 3, 4]
    poses -> the dataset's original space [N, 3, 4], in float64 then f32."""
    out = poses.copy().astype(np.float64)
    out[:, :3, 3] /= applied_scale
    inv = np.linalg.inv(_to44(applied_transform.astype(np.float64)))
    bottom = np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]]), (out.shape[0], 1, 1))
    out44 = np.einsum("ij,njk->nik", inv, np.concatenate([out, bottom], axis=1))
    return out44[:, :3, :4].astype(np.float32)


# ---------------------------------------------------------------------------
# dataparser
# ---------------------------------------------------------------------------


@dataclass
class SIGNeRFDataParserConfig:
    data: Path = Path(".")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: str = "up"  # pca | up | vertical | none
    center_method: str = "poses"  # poses | focus | none
    auto_scale_poses: bool = True
    depth_unit_scale_factor: float = 1e-3


@dataclass
class DataparserOutputs:
    image_filenames: List[Path]
    cameras: Cameras
    scene_box_aabb: np.ndarray  # [2, 3]
    mask_filenames: Optional[List[Path]]
    dataparser_scale: float
    dataparser_transform: np.ndarray  # [3, 4]
    metadata: Dict[str, Any] = field(default_factory=dict)

    def transform_poses_to_original_space(self, poses: np.ndarray) -> np.ndarray:
        return transform_poses_to_original_space(poses, self.dataparser_transform, self.dataparser_scale)


def _image_size(data_dir: Path, meta: Dict[str, Any], frame: Dict[str, Any]) -> Tuple[int, int]:
    """(width, height) of a frame's image: transforms.json's `w`/`h`, else
    the PNG header."""
    if "w" in meta and "h" in meta:
        return int(meta["w"]), int(meta["h"])
    if "w" in frame and "h" in frame:
        return int(frame["w"]), int(frame["h"])
    dims = png_dims(data_dir / frame["file_path"])
    if dims is None:
        raise ValueError(f"{frame['file_path']}: no w/h in transforms.json and not a PNG")
    return dims


def _auto_downscale_factor(
    data_dir: Path,
    filepath: PurePath,
    size: Tuple[int, int],
    configured: Optional[int],
    prefix: str = "images_",
) -> int:
    """A downscale factor that brings the larger side under 1600 px, as far
    as `images_{k}/` folders exist."""
    if configured is not None:
        return configured
    max_res = max(size)
    df = 0
    while max_res / 2**df >= MAX_AUTO_RESOLUTION:
        if not (data_dir / f"{prefix}{2**(df + 1)}" / filepath.name).exists():
            break
        df += 1
    return 2**df


def _get_fname(
    filepath: PurePath, data_dir: Path, downscale_factor: int, prefix: str = "images_"
) -> Path:
    if downscale_factor > 1:
        return data_dir / f"{prefix}{downscale_factor}" / filepath.name
    return data_dir / filepath


def parse_transforms(config: SIGNeRFDataParserConfig) -> DataparserOutputs:
    """Parse a SIGNeRF/nerfstudio transforms.json into DataparserOutputs."""
    data = Path(config.data)
    if not data.exists():
        raise FileNotFoundError(f"Data directory {data} does not exist.")
    if data.suffix == ".json":
        meta = json.loads(data.read_text())
        data_dir = data.parent
    else:
        meta = json.loads((data / "transforms.json").read_text())
        data_dir = data

    frames = meta["frames"]
    fixed = {k: (k in meta) for k in ["fl_x", "fl_y", "cx", "cy", "h", "w"]}
    distort_fixed = any(k in meta for k in ["k1", "k2", "k3", "p1", "p2"])
    original_indices = meta.get("original_indices")

    downscale = None
    image_filenames: List[Path] = []
    mask_filenames: List[Path] = []
    depth_filenames: List[Path] = []
    poses: List[np.ndarray] = []
    fx, fy, cx, cy, hh, ww, distort = [], [], [], [], [], [], []

    def frame_distortion(src: Dict[str, Any]) -> np.ndarray:
        return np.array(
            [float(src.get(k, 0.0)) for k in ["k1", "k2", "k3", "k4", "p1", "p2"]], np.float32
        )

    for idx, frame in enumerate(frames):
        filepath = PurePath(frame["file_path"])
        if downscale is None:
            downscale = _auto_downscale_factor(
                data_dir, filepath, _image_size(data_dir, meta, frame), config.downscale_factor
            )
        fname = _get_fname(filepath, data_dir, downscale)
        if not fname.exists():
            continue

        fx.append(float(meta["fl_x"] if fixed["fl_x"] else frame["fl_x"]))
        fy.append(float(meta["fl_y"] if fixed["fl_y"] else frame["fl_y"]))
        cx.append(float(meta["cx"] if fixed["cx"] else frame["cx"]))
        cy.append(float(meta["cy"] if fixed["cy"] else frame["cy"]))
        hh.append(int(meta["h"] if fixed["h"] else frame["h"]))
        ww.append(int(meta["w"] if fixed["w"] else frame["w"]))
        distort.append(frame_distortion(meta if distort_fixed else frame))
        image_filenames.append(fname)
        key = "scene_transform_matrix" if "scene_transform_matrix" in frame else "transform_matrix"
        poses.append(np.array(frame[key], np.float32))

        if "_mask_path" in frame:
            mask_fname = _get_fname(
                PurePath(frame["_mask_path"]), data_dir, downscale, prefix="masks_"
            )
            if original_indices is not None and idx not in original_indices:
                white_path = mask_fname.parents[0] / "white.png"
                if not white_path.exists():
                    white_path.parent.mkdir(parents=True, exist_ok=True)
                    save_array_png(np.ones((hh[-1], ww[-1]), np.float32), white_path)
                mask_filenames.append(white_path)
            else:
                mask_filenames.append(mask_fname)

        if "depth_file_path" in frame:
            depth_filenames.append(
                _get_fname(PurePath(frame["depth_file_path"]), data_dir, downscale, prefix="depths_")
            )

    if not image_filenames:
        raise ValueError("No image files found; check transforms.json file_paths.")
    if len(mask_filenames) not in (0, len(image_filenames)):
        raise ValueError("mask_path must be specified for every frame or no frame")
    if len(depth_filenames) not in (0, len(image_filenames)):
        raise ValueError("depth_file_path must be specified for every frame or no frame")

    pose_arr = np.stack(poses)  # [N, 4, 4]
    orientation_method = meta.get("orientation_override", config.orientation_method)
    if "original_transform_matrix" in meta:
        transform_matrix = np.array(meta["original_transform_matrix"], np.float32)[:3]
    else:
        pose_arr, transform_matrix = auto_orient_and_center_poses(
            pose_arr, method=orientation_method, center_method=config.center_method
        )

    if "original_scale_factor" in meta:
        scale_factor = float(meta["original_scale_factor"])
    else:
        scale_factor = 1.0
        if config.auto_scale_poses:
            scale_factor /= float(np.max(np.abs(pose_arr[:, :3, 3])))
        scale_factor *= config.scale_factor
        pose_arr[:, :3, 3] *= scale_factor

    aabb = config.scene_scale * np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)

    # One static resolution: every frame takes the smallest frame's size,
    # with its intrinsics rescaled by (sx, sy).
    if len(set(ww)) != 1 or len(set(hh)) != 1:
        tw, th = min(ww), min(hh)
        for i in range(len(ww)):
            sx, sy = tw / ww[i], th / hh[i]
            fx[i] *= sx
            cx[i] *= sx
            fy[i] *= sy
            cy[i] *= sy
            ww[i], hh[i] = tw, th

    cameras = Cameras(
        camera_to_worlds=torch.from_numpy(np.asarray(pose_arr[:, :3, :4], np.float32)),
        fx=torch.tensor(fx, dtype=torch.float32),
        fy=torch.tensor(fy, dtype=torch.float32),
        cx=torch.tensor(cx, dtype=torch.float32),
        cy=torch.tensor(cy, dtype=torch.float32),
        distortion_params=torch.from_numpy(np.stack(distort)),
        width=ww[0],
        height=hh[0],
    ).rescaled(1.0 / downscale)

    if "applied_transform" in meta:
        applied = np.array(meta["applied_transform"], np.float32)
        transform_matrix = (_to44(transform_matrix) @ _to44(applied))[:3]
    if "applied_scale" in meta:
        scale_factor *= float(meta["applied_scale"])
    if "original_indices" not in meta:
        mask_filenames = []

    return DataparserOutputs(
        image_filenames=image_filenames,
        cameras=cameras,
        scene_box_aabb=aabb,
        mask_filenames=mask_filenames or None,
        dataparser_scale=scale_factor,
        dataparser_transform=transform_matrix,
        metadata={
            "downscale_factor": downscale,
            "depth_filenames": depth_filenames or None,
            "depth_unit_scale_factor": config.depth_unit_scale_factor,
            "is_synthetic": meta.get("is_synthetic", False),
            "is_combined": meta.get("is_combined", False),
            "reference_indices": meta.get("reference_indices"),
            "generated_indices": meta.get("generated_indices"),
            "original_indices": meta.get("original_indices"),
        },
    )


def load_previous_experiment_cameras(transforms_path: Path) -> Dict[str, Any]:
    """The reference and synthetic poses of a generated transforms.json:
    {"reference_camera_to_worlds" [R, 3, 4] or None,
    "synthetic_camera_to_worlds" [S, 3, 4] or None, "is_combined"}."""
    meta = json.loads(Path(transforms_path).read_text())
    frames = meta["frames"]

    def pose(i):
        key = "scene_transform_matrix" if "scene_transform_matrix" in frames[i] else "transform_matrix"
        return np.array(frames[i][key], np.float32)[:3, :4]

    refs = meta.get("reference_indices")
    reference = np.stack([pose(i) for i in refs]) if refs else None
    synthetic = None
    if meta.get("is_synthetic") and meta.get("generated_indices"):
        synthetic = np.stack([pose(i) for i in meta["generated_indices"]])
    return {
        "reference_camera_to_worlds": reference,
        "synthetic_camera_to_worlds": synthetic,
        "is_combined": bool(meta.get("is_combined", False)),
    }
