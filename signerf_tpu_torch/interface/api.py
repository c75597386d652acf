"""Headless Generation interface: every control of the "Generation" tab as a
programmatic API.

Port of `signerf_tpu/interface/api.py`. Its setters write through to the
live objects and the configs, as the reference's GUI widgets do; the
built-in web viewer (`interface/app.py`) drives it.

  * general: dataset path and name                  -> set_general
  * reference cameras: circle setter or poses       -> set_reference_circle /
                                                       set_reference_poses
  * dataset cameras: original or synthetic (sphere) -> set_dataset_cameras
  * selection AABB                                  -> set_selection_aabb
  * selection shape: proxy mesh and its pose        -> set_selection_shape
  * generation params: prompt, scales, steps, seed  -> set_generation_params
  * the scene's overlays and their manipulation     -> scene_elements, nudge, drag
  * Preview Generation                              -> preview_generation
  * Generate Dataset & Train                        -> generate_and_train

Poses and sheets are handed out as numpy arrays on the host. On a mesh of
ranks (`interface/channel.py`) every rank runs the same calls in the same
order; the reference sheet of `preview_generation` is inpainted by view
group 0 (rank 0's tensor group), as `generate_dataset` does it. The synthetic
sphere poses draw from a `torch.Generator` seeded with `seed` (the JAX
package draws from `PRNGKey(seed)`, so the poses differ between the
packages for one seed).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from signerf_tpu_torch.cameras.poses import circle_poses, random_sphere_poses


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class GenerationInterface:
    def __init__(self, trainer):
        self.trainer = trainer
        self.reference_poses: Optional[np.ndarray] = None  # [R, 3, 4]
        self.synthetic_poses: Optional[np.ndarray] = None  # [S, 3, 4]
        self.use_synthetic: bool = False
        self.combine_with_original: bool = False
        # The last circle and sphere setters' arguments, so that drag and
        # nudge can re-pose the cameras around a moved center.
        self.circle_params: Dict[str, Any] = dict(
            radius=1.0, theta=70.0, phi_range=(0.0, 360.0),
            position=(0.0, 0.0, 0.0), target=(0.0, 0.0, 0.0),
        )
        self.sphere_params: Dict[str, Any] = dict(
            mode="original", combine_with_original=False, count=60,
            radius=1.0, theta_range=(0.0, 90.0), phi_range=(0.0, 360.0),
            position=(0.0, 0.0, 0.0), target=(0.0, 0.0, 0.0), seed=0,
        )
        self._busy = threading.Lock()

    # ------------------------------------------------------------------
    # general
    # ------------------------------------------------------------------

    @property
    def gen_config(self):
        return self.trainer.config.pipeline.dataset_generator

    def set_general(self, path: Optional[str] = None, dataset_name: Optional[str] = None) -> None:
        if path is not None:
            self.gen_config.path = Path(path)
        if dataset_name is not None:
            self.gen_config.dataset_name = dataset_name

    # ------------------------------------------------------------------
    # reference cameras
    # ------------------------------------------------------------------

    def set_reference_circle(
        self,
        radius: float = 1.0,
        theta: float = 70.0,
        phi_range: Tuple[float, float] = (0.0, 360.0),
        position: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        target: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    ) -> np.ndarray:
        """Place the rows*cols-1 reference cameras on a circle."""
        count = self.gen_config.rows * self.gen_config.cols - 1
        self.circle_params = dict(
            radius=radius, theta=theta, phi_range=tuple(phi_range),
            position=tuple(position), target=tuple(target),
        )
        # endpoint-exclusive spacing, as the GUI's circle setter has it
        span = phi_range[1] - phi_range[0]
        phi = (phi_range[0], phi_range[0] + span * (count - 1) / count)
        poses = circle_poses(count, radius=radius, theta=theta, phi=phi, position=position, target=target)
        self.reference_poses = poses.numpy()[:, :3, :]
        return self.reference_poses

    def set_reference_poses(self, poses: Sequence) -> None:
        arr = np.asarray(poses, np.float32)
        expected = self.gen_config.rows * self.gen_config.cols - 1
        if arr.shape[0] != expected:
            raise ValueError(f"need rows*cols-1 = {expected} reference poses, got {arr.shape[0]}")
        self.reference_poses = arr[:, :3, :4]

    # ------------------------------------------------------------------
    # dataset cameras
    # ------------------------------------------------------------------

    def set_dataset_cameras(
        self,
        mode: str = "original",  # "original" | "synthetic"
        combine_with_original: bool = False,
        count: int = 60,
        radius: float = 1.0,
        theta_range: Tuple[float, float] = (0.0, 90.0),
        phi_range: Tuple[float, float] = (0.0, 360.0),
        position: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        target: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        seed: int = 0,
    ) -> None:
        self.combine_with_original = combine_with_original
        self.sphere_params = dict(
            mode=mode, combine_with_original=combine_with_original,
            count=count, radius=radius, theta_range=tuple(theta_range),
            phi_range=tuple(phi_range), position=tuple(position),
            target=tuple(target), seed=seed,
        )
        if mode == "original":
            self.use_synthetic = False
            self.synthetic_poses = None
            return
        self.use_synthetic = True
        poses = random_sphere_poses(
            count, radius=radius, theta=theta_range, phi=phi_range, position=position, target=target,
            generator=torch.Generator().manual_seed(seed),
        )
        self.synthetic_poses = poses.numpy()[:, :3, :]

    # ------------------------------------------------------------------
    # selection
    # ------------------------------------------------------------------

    def set_selection_aabb(
        self,
        aabb_min: Tuple[float, float, float],
        aabb_max: Tuple[float, float, float],
        inverse_mask: Optional[bool] = None,
    ) -> None:
        self.gen_config.masking_mode = "aabb"
        self.gen_config.aabb_min = tuple(aabb_min)
        self.gen_config.aabb_max = tuple(aabb_max)
        if inverse_mask is not None:
            self.gen_config.inverse_mask = inverse_mask

    def set_selection_shape(
        self,
        object_path: str,
        position: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        scale: Tuple[float, float, float] = (0.1, 0.1, 0.1),
        combine_shape_with_depth: Optional[bool] = None,
    ) -> None:
        self.gen_config.masking_mode = "shape"
        rc = self.gen_config.renderer
        rc.object_path = object_path
        rc.position = tuple(position)
        rc.rotation = tuple(rotation)
        rc.scale = tuple(scale)
        if combine_shape_with_depth is not None:
            self.gen_config.combine_shape_with_depth = combine_shape_with_depth

    # ------------------------------------------------------------------
    # generation params
    # ------------------------------------------------------------------

    def set_generation_params(
        self,
        prompt: Optional[str] = None,
        guidance_scale: Optional[float] = None,
        image_guidance_scale: Optional[float] = None,
        denoising_strength: Optional[float] = None,
        num_inference_steps: Optional[int] = None,
        seed: Optional[int] = None,
        controlnet_conditioning_scale: Optional[float] = None,
    ) -> None:
        d = self.gen_config.diffuser
        for name, val in [
            ("prompt", prompt),
            ("guidance_scale", guidance_scale),
            ("image_guidance_scale", image_guidance_scale),
            ("denoising_strength", denoising_strength),
            ("num_inference_steps", num_inference_steps),
            ("seed", seed),
            ("controlnet_conditioning_scale", controlnet_conditioning_scale),
        ]:
            if val is not None:
                setattr(d, name, val)
        # write through to the live generator and diffuser
        self.trainer.pipeline.dataset_generator.config.diffuser = d
        self.trainer.pipeline.dataset_generator.diffuser.config = d

    # ------------------------------------------------------------------
    # 3D scene elements and their manipulation
    # ------------------------------------------------------------------

    def scene_elements(self) -> Dict[str, Any]:
        """Everything the viewer draws as overlays: train cameras,
        reference and synthetic poses, the selection AABB, the proxy mesh."""
        out: Dict[str, Any] = {
            "train_poses": None,
            "reference_poses": self.reference_poses,
            "synthetic_poses": self.synthetic_poses if self.use_synthetic else None,
            "aabb": None,
            "shape": None,
        }
        dm = getattr(self.trainer.pipeline, "datamanager", None)
        if dm is not None and getattr(dm, "cameras", None) is not None:
            out["train_poses"] = _host(dm.cameras.camera_to_worlds)
        cfg = self.gen_config
        if cfg.masking_mode == "aabb":
            out["aabb"] = (tuple(cfg.aabb_min), tuple(cfg.aabb_max))
        else:
            shape = self._proxy_mesh()
            if shape is not None:
                out["shape"] = shape
        return out

    def _proxy_mesh(self) -> Optional[Dict[str, np.ndarray]]:
        """Load and pose the proxy mesh as the generator will (at a coarser
        subdivision for the wire)."""
        from signerf_tpu_torch.geometry import primitives
        from signerf_tpu_torch.geometry.obj import load_obj, object_pose_matrix, transform_vertices

        rc = self.gen_config.renderer
        if rc.object_path == "bunny":
            verts, faces = primitives.bunny(2)
        elif rc.object_path == "icosphere":
            verts, faces = primitives.icosphere(2, 1.0)
        elif rc.object_path == "cube":
            verts, faces = primitives.cube(1.0)
        else:
            p = Path(rc.object_path)
            if not p.exists():
                return None
            verts, faces = load_obj(p)
        pose = object_pose_matrix(rc.position, rc.rotation, rc.scale)
        return {"verts": transform_vertices(verts, pose), "faces": faces}

    def nudge(
        self,
        element: str,  # "aabb" | "shape" | "reference"
        translate: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        scale: float = 1.0,
        rotate_deg: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    ) -> None:
        """Gizmo steps, written through to the configs."""
        t = np.asarray(translate, np.float64)
        if element == "aabb":
            lo = np.asarray(self.gen_config.aabb_min, np.float64)
            hi = np.asarray(self.gen_config.aabb_max, np.float64)
            center = 0.5 * (lo + hi) + t
            half = 0.5 * (hi - lo) * float(scale)
            self.set_selection_aabb(tuple(center - half), tuple(center + half))
        elif element == "shape":
            rc = self.gen_config.renderer
            rc.position = tuple(np.asarray(rc.position, np.float64) + t)
            rc.scale = tuple(np.asarray(rc.scale, np.float64) * float(scale))
            rc.rotation = tuple(np.asarray(rc.rotation, np.float64) + np.asarray(rotate_deg, np.float64))
        elif element == "reference":
            p = dict(self.circle_params)
            p["position"] = tuple(np.asarray(p["position"], np.float64) + t)
            p["target"] = tuple(np.asarray(p["target"], np.float64) + t)
            p["radius"] = float(p["radius"]) * float(scale)
            self.set_reference_circle(**p)
        else:
            raise ValueError(f"unknown scene element {element!r}")

    def drag(
        self,
        element: str,
        dx_px: float,
        dy_px: float,
        cam: Dict[str, Any],  # {c2w, fx, fy} of the viewing camera
    ) -> None:
        """A screen-space drag -> the element's handle moved in the plane
        through it parallel to the image."""
        from signerf_tpu_torch.interface.overlay import pixel_drag_to_world

        if element == "aabb":
            lo = np.asarray(self.gen_config.aabb_min)
            hi = np.asarray(self.gen_config.aabb_max)
            point = 0.5 * (lo + hi)
        elif element == "shape":
            point = np.asarray(self.gen_config.renderer.position)
        elif element == "reference":
            point = np.asarray(self.circle_params["position"])
        else:
            raise ValueError(f"unknown scene element {element!r}")
        delta = pixel_drag_to_world(dx_px, dy_px, np.asarray(cam["c2w"]), cam["fx"], cam["fy"], point)
        self.nudge(element, translate=tuple(delta))

    # ------------------------------------------------------------------
    # Preview Generation
    # ------------------------------------------------------------------

    def preview_generation(self) -> Optional[Dict[str, np.ndarray]]:
        """Run one reference-sheet generation; return the four sheets
        (original, mask, condition, edited) as float arrays on the host
        (None on a rank outside view group 0, which has no part in it)."""
        if self.reference_poses is None:
            self.set_reference_circle()
        mesh = getattr(self.trainer, "mesh", None)
        if mesh is not None and mesh.view_group != 0:
            return None
        gen = self.trainer.pipeline.dataset_generator
        gen.backfill_intrinsics(self.trainer.pipeline.datamanager.cameras)
        with torch.inference_mode():
            gen.setup_renderer()
            cams = gen._cameras_from_poses(self.reference_poses)
            img, mask, cond, edited, _refs = gen.generate_reference_sheet(cams)
            return {"image": _host(img), "mask": _host(mask), "condition": _host(cond), "edited": _host(edited)}

    # ------------------------------------------------------------------
    # Generate Dataset & Train
    # ------------------------------------------------------------------

    def generate_and_train(self) -> None:
        """Generate the edited dataset, exchange it (the model reloaded
        without its proposal networks) and train."""
        with self._busy:
            if self.reference_poses is None:
                self.set_reference_circle()
            kwargs: Dict[str, Any] = {"reference_camera_to_worlds": self.reference_poses}
            if self.use_synthetic:
                kwargs["synthetic_camera_to_worlds"] = self.synthetic_poses
                kwargs["merge_with_original_dataset"] = self.combine_with_original
            generated = self.trainer.generate_dataset(**kwargs)
            self.trainer.exchange_training_dataset(generated)
            self.trainer.train()
