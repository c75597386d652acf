"""Dataset generator: the reference sheet and the regeneration of every view.

Port of `signerf_tpu/generator/datasetgenerator.py`, with its knobs,
defaults, output schema and call order:

  * the directory `images/ masks/ conditions/ rendered/ originals/`, each
    also at `_{downscale_factor}`, `references/`, `config.yml` and
    `transforms.json`;
  * `generate_reference_sheet`: rows * cols - 1 views composed into one
    padded grid, one inpaint, the blend with the mask, the cells split back;
  * `generate_with_reference_sheet` (and its batched form): each view
    rendered, masked and conditioned, spliced into the sheet's last cell,
    inpainted, cropped, blended and upscaled;
  * `render_camera`: the NeRF's render plus mask and condition in the
    `shape` and `aabb` modes (`editing/conditions.py`);
  * the merge with the original dataset under inverted masks;
  * `transforms.json` rewritten after each phase, so a crash leaves a
    dataset that lists only frames on disk but for the latest chunk.

Renders, masks, conditions, resizes and the sheet stay on the generator's
device (the card unless the caller names another); PNGs are moved to the
host and encoded by a thread pool, and original photos are decoded one
chunk ahead by another.

With a `DataMesh` (`parallel/mesh.py`), rank 0 builds and inpaints the
reference sheet, saves it and the reference views, and broadcasts the
edited and condition sheets; every rank then builds its own sheet cache,
checks that its SDXL weights equal rank 0's, and runs the chunks of
`generation_batch_size` views dealt to it round-robin, each chunk called
exactly as one rank calls it (the same views, batch and draws), so the
dataset does not depend on the number of ranks. Each rank writes its
views' PNGs under their global indices; rank 0 gathers the frame entries,
writes `transforms.json` in view order and runs the merge with the
original dataset; a barrier ends the call. (The JAX package splits the
views of one chunk over its devices instead; the port's draws belong to
the chunk.)
"""

from __future__ import annotations

import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from signerf_tpu_torch import config as cfglib
from signerf_tpu_torch.cameras.cameras import Cameras
from signerf_tpu_torch.data.datamanager import resize_bilinear_u8
from signerf_tpu_torch.diffusion.diffuser import IN_PROCESS, Diffuser, DiffuserConfig
from signerf_tpu_torch.diffusion.sdxl_pipeline import resolve_device
from signerf_tpu_torch.editing.conditions import MaskingConfig, aabb_mask_condition, shape_mask_condition
from signerf_tpu_torch.editing.sheet import (
    SheetLayout,
    blend_with_mask,
    compose_sheet,
    extract_last_cell,
    resize_bilinear,
    resize_mask,
    splice_last_cell,
    split_cells,
)
from signerf_tpu_torch.utils.images import load_rgb, save_array_png

if TYPE_CHECKING:
    from signerf_tpu_torch.parallel.mesh import DataMesh

# render_fn(cameras, camera_index) -> {"rgb": [H, W, 3], "depth": [H, W, 1]}
RenderFn = Callable[[Cameras, int], Dict[str, torch.Tensor]]


@dataclasses.dataclass
class RendererConfig:
    """Placement of the proxy object."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # XYZ Euler, degrees
    scale: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    # An OBJ path or a primitive name ("bunny" | "icosphere" | "cube").
    object_path: str = "bunny"


@dataclasses.dataclass
class DatasetGeneratorConfig:
    path: Path = Path("./generations")
    dataset_name: str = "experiment"
    downscale_factor: int = 2
    fx: Optional[float] = None
    fy: Optional[float] = None
    cx: Optional[float] = None
    cy: Optional[float] = None
    width: Optional[int] = None
    height: Optional[int] = None
    masking_mode: str = "aabb"  # "shape" | "aabb"
    aabb_min: Tuple[float, float, float] = (-0.1, -0.1, -0.1)
    aabb_max: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    rows: int = 2
    cols: int = 3
    mask_dilation: Optional[Tuple[int, int]] = (50, 50)
    additional_depth_radius: float = 0.1
    renderer: RendererConfig = dataclasses.field(default_factory=RendererConfig)
    diffuser: DiffuserConfig = dataclasses.field(default_factory=DiffuserConfig)
    border_width_between_images: int = 0
    inverse_mask: bool = False
    manual_depth: Optional[Tuple[float, float]] = None
    combine_shape_with_depth: bool = False
    generation_batch_size: int = 4
    """Views diffused per call of the per-view loop (`Diffuser.diffuse_batch`);
    1 is the reference's serial loop. The in-process pipeline runs a batch
    view by view where batching would cross its attention-memory threshold."""
    lastcell_vae_window: bool = True
    """Per-view VAE fast path (in-process diffuser only): the sheet's encoder
    features are computed once, and each view re-encodes and decodes only a
    padded window around the last cell (`sdxl_pipeline.SheetEncodeCache`).
    It differs from the full path by the GroupNorm statistics seen over the
    window. False runs the full-sheet VAE for every view."""


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _save_png(arr, path: Path) -> None:
    """Move `arr` to the host and write it as a PNG (the writer threads'
    task, so the transfer and the encode leave the main thread)."""
    save_array_png(_host(arr), path)


class DatasetGenerator:
    def __init__(
        self,
        config: DatasetGeneratorConfig,
        original_transform_matrix: np.ndarray,  # [3|4, 4]
        original_scale_factor: float,
        transform_poses_to_original_space: Callable[[np.ndarray], np.ndarray],
        render_fn: RenderFn,
        diffuser: Optional[Diffuser] = None,
        device=None,
        mesh: Optional["DataMesh"] = None,
    ):
        """`device`: where cameras, masks and sheets live (None: the card).
        `mesh`: the data-parallel group the per-view chunks are dealt over."""
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.original_transform_matrix = np.asarray(original_transform_matrix)
        self.original_scale_factor = float(original_scale_factor)
        self.transform_poses_to_original_space = transform_poses_to_original_space
        self.render_fn = render_fn
        self.diffuser = diffuser or Diffuser(config.diffuser, device=self.device)
        self.is_synthetic = False
        self._mesh: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.dataset_path: Optional[Path] = None
        self._save_pool: Optional[ThreadPoolExecutor] = None
        self._prefetch_pool: Optional[ThreadPoolExecutor] = None
        self._pending_prev: List = []
        self._pending_cur: List = []
        # Wall time of the last generate_dataset(): {"sheet_s": s, "view_s":
        # [s per chunk of the per-view loop]}.
        self.last_timings: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # intrinsics and cameras
    # ------------------------------------------------------------------

    def backfill_intrinsics(self, cameras: Cameras) -> None:
        """Unset intrinsics and size come from camera 0 of `cameras`."""
        c = self.config
        if c.fx is None:
            c.fx = float(cameras.fx[0])
        if c.fy is None:
            c.fy = float(cameras.fy[0])
        if c.cx is None:
            c.cx = float(cameras.cx[0])
        if c.cy is None:
            c.cy = float(cameras.cy[0])
        if c.width is None:
            c.width = int(cameras.width)
        if c.height is None:
            c.height = int(cameras.height)

    def _cameras_from_poses(self, c2ws: np.ndarray) -> Cameras:
        c = self.config
        n = c2ws.shape[0]
        full = lambda v: torch.full((n,), float(v), dtype=torch.float32, device=self.device)  # noqa: E731
        return Cameras(
            camera_to_worlds=torch.as_tensor(np.array(c2ws[:, :3, :4], np.float32), device=self.device),
            fx=full(c.fx),
            fy=full(c.fy),
            cx=full(c.cx),
            cy=full(c.cy),
            width=int(c.width),
            height=int(c.height),
        )

    # ------------------------------------------------------------------
    # proxy mesh
    # ------------------------------------------------------------------

    def setup_renderer(self) -> None:
        """Load and pose the proxy mesh."""
        from signerf_tpu_torch.geometry import primitives
        from signerf_tpu_torch.geometry.obj import load_obj, object_pose_matrix, transform_vertices

        rc = self.config.renderer
        if rc.object_path == "bunny":
            verts, faces = primitives.bunny(3)
        elif rc.object_path == "icosphere":
            verts, faces = primitives.icosphere(3, 1.0)
        elif rc.object_path == "cube":
            verts, faces = primitives.cube(1.0)
        else:
            path = Path(rc.object_path)
            if not path.exists() or path.suffix != ".obj":
                print(f"[generator] proxy mesh {path} missing; skipping setup")
                return
            verts, faces = load_obj(path)
        verts = transform_vertices(verts, object_pose_matrix(rc.position, rc.rotation, rc.scale))
        self._mesh = (
            torch.as_tensor(np.asarray(verts, np.float32), device=self.device),
            torch.as_tensor(np.asarray(faces), device=self.device),
        )

    def _mesh_render(self, cameras: Cameras, index: int):
        from signerf_tpu_torch.geometry.raster import mesh_depth_render

        assert self._mesh is not None, "setup_renderer() not called"
        verts, faces = self._mesh
        return mesh_depth_render(cameras, verts, faces, color=self.config.renderer.color[:3], camera_index=index)

    # ------------------------------------------------------------------
    # directory, PNG writers, transforms
    # ------------------------------------------------------------------

    _DIRS = ("images", "masks", "conditions", "rendered", "originals")

    def init_directory(self) -> None:
        c = self.config
        self.dataset_path = Path(c.path) / c.dataset_name
        for name in self._DIRS:
            (self.dataset_path / name).mkdir(parents=True, exist_ok=True)
            (self.dataset_path / f"{name}_{c.downscale_factor}").mkdir(parents=True, exist_ok=True)
        (self.dataset_path / "references").mkdir(parents=True, exist_ok=True)
        if self.is_main:
            cfglib.save_yaml(c, self.dataset_path / "config.yml")

    def _base_transforms(self, merged: bool) -> Dict[str, Any]:
        return {
            "camera_model": "OPENCV",
            "orientation_override": "none",
            "method": "SIGNeRF",
            "is_synthetic": self.is_synthetic,
            "is_combined": merged,
            "frames": [],
            "original_transform_matrix": self.original_transform_matrix.tolist(),
            "original_scale_factor": self.original_scale_factor,
        }

    def _submit_save(self, arr, path: Path) -> None:
        """Queue a PNG save on the writer pool. `arr` must not be written in
        place afterwards: the worker reads it later."""
        if self._save_pool is None:
            self._save_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="png-writer")
        self._pending_cur.append(self._save_pool.submit(_save_png, arr, path))

    def flush_saves(self) -> None:
        """Wait for every queued PNG save (re-raising a worker's exception)."""
        for fut in self._pending_prev + self._pending_cur:
            fut.result()
        self._pending_prev, self._pending_cur = [], []

    def _decode_original(self, filename: Path) -> np.ndarray:
        """One original photo -> float32 [H, W, 3] in [0, 1] on the host, at
        the generator's size: the port's PNG decoder, and the resize of the
        JAX package's native codec (`data/datamanager.resize_bilinear_u8`)."""
        c = self.config
        u8 = resize_bilinear_u8(load_rgb(filename), int(c.width), int(c.height))
        return u8.astype(np.float32) / np.float32(255.0)

    def _prefetch_originals(self, filenames, indices, futures) -> None:
        """Queue host decodes of `indices` on the prefetch pool, so that they
        run while the device works on the previous chunk."""
        if self._prefetch_pool is None:
            self._prefetch_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="png-prefetch")
        for i in indices:
            if filenames[i] is not None and i not in futures:
                futures[i] = self._prefetch_pool.submit(self._decode_original, filenames[i])

    def _write_transforms(self, transforms: Dict[str, Any]) -> None:
        # Resume invariant, relaxed by one chunk: every save queued before
        # the previous write is on disk before this write lands, so
        # transforms.json lists at most the latest chunk's frames before
        # their PNGs. generate_dataset() ends with flush_saves().
        for fut in self._pending_prev:
            fut.result()
        self._pending_prev, self._pending_cur = self._pending_cur, []
        with open(self.dataset_path / "transforms.json", "w") as fh:
            json.dump(transforms, fh, indent=4)

    # ------------------------------------------------------------------
    # render + mask + condition of one camera
    # ------------------------------------------------------------------

    def render_camera(
        self, cameras: Cameras, index: int, with_mask: bool = True, with_condition: bool = True
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        c = self.config
        outputs = self.render_fn(cameras, index)
        rgb = outputs["rgb"]  # [H, W, 3]
        depth = outputs["depth"]  # [H, W, 1]
        if not with_mask:
            return rgb, None, None
        mcfg = MaskingConfig(
            masking_mode=c.masking_mode,
            aabb_min=tuple(c.aabb_min),
            aabb_max=tuple(c.aabb_max),
            mask_dilation=c.mask_dilation,
            additional_depth_radius=c.additional_depth_radius,
            manual_depth=c.manual_depth,
            inverse_mask=c.inverse_mask,
            combine_shape_with_depth=c.combine_shape_with_depth,
        )
        if c.masking_mode == "shape":
            _, mesh_depth = self._mesh_render(cameras, index)
            mask, cond = shape_mask_condition(depth, mesh_depth, mcfg)
        else:
            rb = cameras.generate_rays(camera_index=index)
            mesh_depth = mesh_color = None
            if c.combine_shape_with_depth and self._mesh is not None:
                mesh_color, mesh_depth = self._mesh_render(cameras, index)
            mask, cond = aabb_mask_condition(
                depth, rb.origins, rb.directions, mcfg, mesh_depth=mesh_depth, mesh_color=mesh_color
            )
        if not with_condition:
            return rgb, mask, None
        return rgb, mask, cond

    # ------------------------------------------------------------------
    # reference sheet
    # ------------------------------------------------------------------

    def _print(self, *args, **kwargs) -> None:
        if self.is_main:
            print(*args, **kwargs)

    def _layout(self) -> SheetLayout:
        c = self.config
        return SheetLayout(
            rows=c.rows,
            cols=c.cols,
            cell_height=int(c.height) // c.downscale_factor,
            cell_width=int(c.width) // c.downscale_factor,
            border=c.border_width_between_images,
        )

    def _diffused(self, out) -> torch.Tensor:
        return torch.as_tensor(out, dtype=torch.float32, device=self.device)

    def generate_reference_sheet(self, cameras: Cameras):
        c = self.config
        lo = self._layout()
        n_ref = len(cameras)
        if n_ref != c.rows * c.cols - 1:
            raise ValueError(
                f"Camera count {n_ref} is not equal to (rows * cols) - 1 = {c.rows * c.cols - 1}"
            )
        sh, sw = lo.cell_height, lo.cell_width
        references: List[Dict[str, torch.Tensor]] = []
        imgs, msks, cnds = [], [], []
        for i in range(n_ref):
            render, mask, cond = self.render_camera(cameras, i)
            r_s = resize_bilinear(render, sh, sw)
            m_s = resize_mask(mask, sh, sw)
            c_s = resize_bilinear(cond, sh, sw)
            imgs.append(r_s)
            msks.append(m_s)
            cnds.append(c_s)
            references.append(
                {
                    "render": render,
                    "mask": mask,
                    "condition": cond,
                    "render_scaled": r_s,
                    "mask_scaled": m_s,
                    "condition_scaled": c_s,
                }
            )
        image_sheet, mask_sheet, cond_sheet = compose_sheet(lo, imgs, msks, cnds)

        # A reference cell without an edit mask passes through the inpaint
        # unedited and weakens the sheet's multi-view context. The usual
        # cause is floater density in front of the camera, so the depth
        # never falls inside the selection box.
        for i, m in enumerate(msks):
            if float(m.mean()) == 0.0:
                print(
                    f"[generator] WARNING: reference view {i} has an EMPTY edit mask — its sheet cell "
                    f"will not be edited (likely floater density in front of the selection; check the "
                    f"NeRF's depth at that pose)",
                    flush=True,
                )

        edited_sheet = self._diffused(
            self.diffuser.diffuse(image_sheet, image_sheet, mask_sheet, cond_sheet, device_out=True)
        )
        edited_sheet = blend_with_mask(edited_sheet, image_sheet, mask_sheet)
        for i, cell in enumerate(split_cells(lo, edited_sheet, n_ref)):
            references[i]["edited_scaled"] = cell
            references[i]["edited"] = resize_bilinear(cell, int(c.height), int(c.width))
        return image_sheet, mask_sheet, cond_sheet, edited_sheet, references

    # ------------------------------------------------------------------
    # per-view generation
    # ------------------------------------------------------------------

    def _cell_from_edited(self, lo: SheetLayout, edited: torch.Tensor) -> torch.Tensor:
        """The last cell of a full edited sheet, or of the bottom-right
        decode window that the `lastcell_vae_window` path returns (the
        sheet's /8 padding puts the cell up to 7 px in from its corner)."""
        if tuple(edited.shape[:2]) == (lo.height, lo.width):
            return extract_last_cell(lo, edited)
        rs, cs = lo.cell_slice(lo.last_index)
        off_h = lo.height - rs.stop  # /8 padding below the cell
        off_w = lo.width - cs.stop
        wh, ww = edited.shape[:2]
        return edited[wh - off_h - lo.cell_height : wh - off_h, ww - off_w - lo.cell_width : ww - off_w]

    def _view_inputs(self, cameras: Cameras, index: int, filename, decoded):
        """(render, mask, condition) of one view, the render replaced by the
        original photo when there is one, and their cell-size versions."""
        lo = self._layout()
        render, mask, cond = self.render_camera(cameras, index)
        if decoded is None and filename is not None:
            decoded = self._decode_original(filename)
        if decoded is not None:
            render = torch.as_tensor(decoded, dtype=torch.float32, device=self.device)
        r_s = resize_bilinear(render, lo.cell_height, lo.cell_width)
        m_s = resize_mask(mask, lo.cell_height, lo.cell_width)
        c_s = resize_bilinear(cond, lo.cell_height, lo.cell_width)
        return render, mask, cond, r_s, m_s, c_s

    def _finish_view(self, lo: SheetLayout, edited_sheet, render, mask, cond, r_s, m_s, c_s):
        c = self.config
        edited_scaled = blend_with_mask(self._cell_from_edited(lo, self._diffused(edited_sheet)), r_s, m_s)
        return {
            "render": render,
            "mask": mask,
            "condition": cond,
            "edited": resize_bilinear(edited_scaled, int(c.height), int(c.width)),
            "render_scaled": r_s,
            "mask_scaled": m_s,
            "condition_scaled": c_s,
            "edited_scaled": edited_scaled,
        }

    def generate_with_reference_sheet(
        self,
        cameras: Cameras,
        index: int,
        filename: Optional[Path],
        image_sheet: torch.Tensor,
        cond_sheet: torch.Tensor,
        decoded: Optional[np.ndarray] = None,
        sheet_cache=None,
    ) -> Dict[str, torch.Tensor]:
        lo = self._layout()
        view = self._view_inputs(cameras, index, filename, decoded)
        image_sheet2, mask_sheet, cond_sheet2 = splice_last_cell(lo, image_sheet, cond_sheet, *view[3:])
        edited_sheet = self.diffuser.diffuse(
            image_sheet2, image_sheet2, mask_sheet, cond_sheet2, device_out=True, sheet_cache=sheet_cache
        )
        return self._finish_view(lo, edited_sheet, *view)

    def generate_with_reference_sheet_batch(
        self,
        cameras: Cameras,
        indices: List[int],
        filenames: List[Optional[Path]],
        image_sheet: torch.Tensor,
        cond_sheet: torch.Tensor,
        decodeds: Optional[List[Optional[np.ndarray]]] = None,
        sheet_cache=None,
    ) -> List[Dict[str, torch.Tensor]]:
        """K views spliced into K copies of the sheet and diffused in one
        `Diffuser.diffuse_batch` call; the same as K calls of
        `generate_with_reference_sheet` but for the diffusion's draws."""
        lo = self._layout()
        views, sheets = [], []
        for pos, (idx, filename) in enumerate(zip(indices, filenames)):
            view = self._view_inputs(cameras, idx, filename, None if decodeds is None else decodeds[pos])
            views.append(view)
            sheets.append(splice_last_cell(lo, image_sheet, cond_sheet, *view[3:]))
        # The in-process pipeline takes the batch on the device; the other
        # modes take host arrays.
        on_device = self.diffuser.config.mode in IN_PROCESS
        stack = torch.stack if on_device else np.stack
        batch_i, batch_m, batch_c = (
            stack([s[j] if on_device else _host(s[j]) for s in sheets]) for j in range(3)
        )
        edited = self.diffuser.diffuse_batch(
            batch_i, batch_i, batch_m, batch_c, device_out=on_device, sheet_cache=sheet_cache
        )
        return [self._finish_view(lo, edited[k], *view) for k, view in enumerate(views)]

    # ------------------------------------------------------------------
    # saving
    # ------------------------------------------------------------------

    def save_generated_images(
        self,
        idx: int,
        images: Dict[str, torch.Tensor],
        cameras: Cameras,
        cam_index: int,
        transforms: Dict[str, Any],
        is_original: bool = False,
    ) -> Dict[str, Any]:
        dp = self.dataset_path
        ds = self.config.downscale_factor
        targets = {
            "edited": dp / "images" / f"image_{idx}.png",
            "render": dp / ("originals" if is_original else "rendered") / f"image_{idx}.png",
            "mask": dp / "masks" / f"mask_{idx}.png",
            "condition": dp / "conditions" / f"condition_{idx}.png",
            "edited_scaled": dp / f"images_{ds}" / f"image_{idx}.png",
            "render_scaled": dp / f"rendered_{ds}" / f"image_{idx}.png",
            "mask_scaled": dp / f"masks_{ds}" / f"mask_{idx}.png",
            "condition_scaled": dp / f"conditions_{ds}" / f"condition_{idx}.png",
        }
        for key, path in targets.items():
            if key in images:
                self._submit_save(images[key], path)

        c2w = _host(cameras.camera_to_worlds[cam_index])  # [3, 4]
        scene_tm = np.concatenate([c2w, [[0.0, 0.0, 0.0, 1.0]]], axis=0)
        transforms["frames"].append(
            {
                "fl_x": float(cameras.fx[cam_index]),
                "fl_y": float(cameras.fy[cam_index]),
                "cx": float(cameras.cx[cam_index]),
                "cy": float(cameras.cy[cam_index]),
                "w": int(cameras.width),
                "h": int(cameras.height),
                "file_path": f"./images/image_{idx}.png",
                "_mask_path": f"./masks/mask_{idx}.png",
                # The scene-space pose under both keys, as the reference.
                "transform_matrix": scene_tm.tolist(),
                "scene_transform_matrix": scene_tm.tolist(),
            }
        )
        return transforms

    # ------------------------------------------------------------------
    # the whole generation
    # ------------------------------------------------------------------

    def generate_dataset(
        self,
        reference_camera_to_worlds: np.ndarray,  # [R, 3|4, 4]
        original_cameras: Optional[Cameras] = None,
        original_filenames: Optional[Sequence[Optional[Path]]] = None,
        original_images=None,  # [N, H, W, 3] float in [0, 1], numpy or a tensor
        synthetic_camera_to_worlds: Optional[np.ndarray] = None,
        merge_with_original_dataset: bool = False,
    ) -> Path:
        c = self.config
        if original_cameras is None and synthetic_camera_to_worlds is None:
            raise ValueError("Either original dataset or camera_to_worlds must be given")
        if merge_with_original_dataset and (original_cameras is None or synthetic_camera_to_worlds is None):
            raise ValueError("Original dataset and camera_to_worlds must be given to merge")

        self.init_directory()
        self.setup_renderer()
        self.is_synthetic = synthetic_camera_to_worlds is not None

        t_start = time.time()
        ref_cams = self._cameras_from_poses(np.asarray(reference_camera_to_worlds))
        if synthetic_camera_to_worlds is not None:
            gen_cams = self._cameras_from_poses(np.asarray(synthetic_camera_to_worlds))
            gen_filenames: List[Optional[Path]] = [None] * len(gen_cams)
        else:
            gen_cams = original_cameras
            gen_filenames = list(original_filenames or [None] * len(gen_cams))

        transforms = self._base_transforms(merge_with_original_dataset)
        n_ref = len(ref_cams)
        edited_sheet = cond_sheet = None
        if self.is_main:
            image_sheet, mask_sheet, cond_sheet, edited_sheet, references = self.generate_reference_sheet(ref_cams)
            refs_dir = self.dataset_path / "references"
            for name, sheet in (("image", image_sheet), ("mask", mask_sheet), ("condition", cond_sheet),
                                ("edited", edited_sheet)):
                _save_png(sheet, refs_dir / f"{name}_reference_sheet.png")

            transforms["reference_indices"] = []
            for i in range(n_ref):
                transforms = self.save_generated_images(i, references[i], ref_cams, i, transforms)
                transforms["reference_indices"].append(i)
            self._write_transforms(transforms)
        if self.mesh is not None:
            edited_sheet, cond_sheet = self.mesh.broadcast_tensors(None if edited_sheet is None
                                                                   else [edited_sheet, cond_sheet])
            if self.diffuser.config.mode in IN_PROCESS:
                self.mesh.assert_replicas_equal(self.diffuser.pipeline.tensors(), "the SDXL weights")
        self.last_timings = {"sheet_s": time.time() - t_start, "view_s": []}
        self._print(
            f"[generator] reference sheet + {n_ref} reference views done ({time.time() - t_start:.0f}s)",
            flush=True,
        )

        transforms["generated_indices"] = []
        own_frames = len(transforms["frames"])
        bsz = max(1, int(c.generation_batch_size))
        chunks = [list(range(start, min(start + bsz, len(gen_cams)))) for start in range(0, len(gen_cams), bsz)]
        if self.mesh is not None:
            chunks = chunks[self.mesh.rank :: self.mesh.world_size]
        # Every view is spliced into the same edited sheet, so its encoder
        # features are computed once here (see lastcell_vae_window).
        sheet_cache = None
        if c.lastcell_vae_window:
            lo = self._layout()
            sheet_cache = self.diffuser.prepare_sheet_cache(edited_sheet, (lo.cell_height, lo.cell_width))
        t_prev = time.time()
        prefetched: Dict[int, Any] = {}
        self._prefetch_originals(gen_filenames, chunks[0] if chunks else [], prefetched)
        for pos, chunk in enumerate(chunks):
            # The next chunk's decodes run while this chunk's device work does.
            self._prefetch_originals(gen_filenames, chunks[pos + 1] if pos + 1 < len(chunks) else [], prefetched)
            decoded = [prefetched.pop(i).result() if i in prefetched else None for i in chunk]
            if bsz == 1:
                images_list = [
                    self.generate_with_reference_sheet(
                        gen_cams, chunk[0], gen_filenames[chunk[0]], edited_sheet, cond_sheet,
                        decoded=decoded[0], sheet_cache=sheet_cache,
                    )
                ]
            else:
                images_list = self.generate_with_reference_sheet_batch(
                    gen_cams, chunk, [gen_filenames[i] for i in chunk], edited_sheet, cond_sheet,
                    decodeds=decoded, sheet_cache=sheet_cache,
                )
            for i, images in zip(chunk, images_list):
                transforms = self.save_generated_images(
                    n_ref + i, images, gen_cams, i, transforms, is_original=gen_filenames[i] is not None
                )
                transforms["generated_indices"].append(n_ref + i)
            if self.mesh is None:
                self._write_transforms(transforms)
            now = time.time()
            self.last_timings["view_s"].append(now - t_prev)
            t_prev = now
            self._print(f"[generator] views {chunk[-1] + 1}/{len(gen_cams)} ({now - t_start:.0f}s)", flush=True)

        if self.mesh is not None:
            # every rank's views on disk, then their frames in view order
            self.flush_saves()
            mine = list(zip(transforms["generated_indices"], transforms["frames"][own_frames:]))
            gathered = sorted(f for part in self.mesh.gather_objects(mine) for f in part)
            if self.is_main:
                transforms["frames"][own_frames:] = [frame for _, frame in gathered]
                transforms["generated_indices"] = [i for i, _ in gathered]
                self._write_transforms(transforms)
        idx = n_ref + len(gen_cams)

        if merge_with_original_dataset and self.is_main:
            transforms["original_indices"] = []
            lo = self._layout()
            sh, sw = lo.cell_height, lo.cell_width
            for i in range(len(original_cameras)):
                image = torch.as_tensor(original_images[i], dtype=torch.float32, device=self.device)
                render, mask, cond = self.render_camera(original_cameras, i)
                mask = 1.0 - mask  # inverted: the originals keep everything but the object
                images = {
                    "render": render,
                    "mask": mask,
                    "condition": cond,
                    "edited": image,
                    "render_scaled": resize_bilinear(render, sh, sw),
                    "mask_scaled": resize_mask(mask, sh, sw),
                    "condition_scaled": resize_bilinear(cond, sh, sw),
                    "edited_scaled": resize_bilinear(image, sh, sw),
                }
                transforms = self.save_generated_images(idx, images, original_cameras, i, transforms, True)
                transforms["original_indices"].append(idx)
                idx += 1
            self._write_transforms(transforms)

        self.flush_saves()
        if self.mesh is not None:
            self.mesh.barrier()
        self._print(f"[generator] dataset generated in {(time.time() - t_start) / 60:.2f} minutes -> {self.dataset_path}")
        return self.dataset_path
