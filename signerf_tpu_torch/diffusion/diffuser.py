"""Diffuser: the inpainting interface of the dataset generator (the port of
`signerf_tpu/diffusion/diffuser.py`).

Same knobs (`DiffuserConfig`) and the same `diffuse(original, rendered,
mask, condition)` contract, with three modes:

  * ``torch_sdxl`` (the default; ``jax_sdxl`` is accepted as the same
    backend, so configs written for the JAX package run unchanged): the
    in-process SDXL base + ControlNet-depth inpaint of `sdxl_pipeline`, on
    the card unless the Diffuser is given `device="cpu"`.
  * ``remote_sdwebui``: the wire-compatible HTTP client to an A1111 SD Web
    UI server (the same payload as the JAX package); `requests` and Pillow
    are imported inside the call. A connection failure returns the
    original image.
  * ``custom``: a pluggable callable, `custom_fn`.

Images are float [H, W, C] numpy arrays in [0, 1] (C = 3 or 1).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

import numpy as np

DiffuseFn = Callable[[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]], np.ndarray]
IN_PROCESS = ("torch_sdxl", "jax_sdxl")


@dataclasses.dataclass
class DiffuserConfig:
    mode: str = "torch_sdxl"  # torch_sdxl (= jax_sdxl) | remote_sdwebui | custom
    url: str = "http://127.0.0.1"
    port: int = 5000
    prompt: str = "don't change the image"
    negative_prompt: str = ""
    guidance_scale: float = 7.0
    image_guidance_scale: float = 1.5
    denoising_strength: float = 0.9
    num_inference_steps: int = 20
    lower_bound: float = 0.02
    upper_bound: float = 0.98
    seed: int = 1
    stable_diffusion_model: str = "sd_xl_base_1.0.safetensors [31e35c80fc]"
    controlnet_model: str = "diffusers_xl_depth_full [2f51180b]"
    controlnet_lowvram: bool = False
    controlnet_conditioning_scale: float = 0.8
    controlnet_conditioning_scale_start: float = 0.0
    controlnet_conditioning_scale_end: float = 1.0
    controlnet_control_mode: str = "Balanced"
    # in-process knobs
    # directory with sdxl_params.pt or the JAX package's sdxl_params.msgpack; random if None
    sdxl_weights_path: Optional[str] = None
    mask_blur: int = 4
    inpainting_fill: int = 1  # A1111 fill mode: 0 fill, 1 original, 2 noise, 3 zeros
    # Accepted for config parity. Under the port's data mesh each rank holds
    # the whole pipeline and takes whole chunks of views; the "tensor" axis
    # this names in the JAX package (SDXL tensor parallelism) is not ported.
    sharding_axis: Optional[str] = None


class Diffuser:
    """Dispatches `diffuse` to the configured backend."""

    def __init__(self, config: DiffuserConfig, custom_fn: Optional[DiffuseFn] = None, device=None, pipeline=None):
        """`device`: where the in-process pipeline runs (None: the card).
        `pipeline`: an `SDXLInpaintPipeline` to use instead of building one
        at first use (the full architecture, from `sdxl_weights_path`)."""
        self.config = config
        self.custom_fn = custom_fn
        self.device = device
        self._sdxl = pipeline

    def _in_process(self) -> bool:
        return self.config.mode in IN_PROCESS

    def prepare_sheet_cache(self, sheet_image, cell_hw):
        """The cross-view VAE cache for the per-view loop (in-process mode
        only; other modes return None and `diffuse` ignores it)."""
        if not self._in_process():
            return None
        return self._get_sdxl().prepare_sheet_cache(sheet_image, cell_hw)

    def diffuse(self, original_image, rendered_image, mask_image=None, condition_image=None,
                device_out: bool = False, sheet_cache=None):
        """Edit `original_image` guided by the depth condition; returns
        [H, W, 3] float (the window with a matching `sheet_cache`)."""
        mode = self.config.mode
        if mode == "custom":
            if self.custom_fn is None:
                raise ValueError("Diffuser mode 'custom' requires a custom_fn")
            return self.custom_fn(*self._host(original_image, rendered_image, mask_image, condition_image))
        if mode == "remote_sdwebui":
            return self._diffuse_remote(*self._host(original_image, rendered_image, mask_image, condition_image))
        if self._in_process():
            return self._img2img(original_image, mask_image, condition_image, device_out, sheet_cache)
        raise ValueError(f"unknown diffuser mode {mode!r}")

    def diffuse_batch(self, original_images, rendered_images, mask_images=None, condition_images=None,
                      device_out: bool = False, sheet_cache=None):
        """Batched edit: the in-process mode diffuses all K images in one
        `img2img` call (the per-view fast path); other modes loop."""
        if self._in_process():
            return self._img2img(original_images, mask_images, condition_images, device_out, sheet_cache)
        return np.stack([
            self.diffuse(original_images[i], rendered_images[i],
                         None if mask_images is None else mask_images[i],
                         None if condition_images is None else condition_images[i])
            for i in range(len(original_images))
        ])

    @staticmethod
    def _host(*arrays):
        """numpy copies on the host (tensors on any device, or arrays)."""
        return tuple(
            None if a is None else a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
            for a in arrays
        )

    @property
    def pipeline(self):
        """The in-process `SDXLInpaintPipeline` (built at first use)."""
        return self._get_sdxl()

    def _get_sdxl(self):
        if self._sdxl is None:
            from signerf_tpu_torch.diffusion.sdxl_pipeline import SDXLInpaintPipeline

            self._sdxl = SDXLInpaintPipeline.create(weights_path=self.config.sdxl_weights_path, device=self.device)
        return self._sdxl

    def _img2img(self, image, mask, condition, device_out, sheet_cache):
        cfg = self.config
        return self._get_sdxl().img2img(
            image=image,
            prompt=cfg.prompt,
            negative_prompt=cfg.negative_prompt,
            mask=mask,
            control_image=condition,
            strength=cfg.denoising_strength,
            num_steps=cfg.num_inference_steps,
            guidance_scale=cfg.guidance_scale,
            controlnet_scale=cfg.controlnet_conditioning_scale,
            controlnet_start=cfg.controlnet_conditioning_scale_start,
            controlnet_end=cfg.controlnet_conditioning_scale_end,
            seed=cfg.seed,
            mask_blur=cfg.mask_blur,
            inpainting_fill=cfg.inpainting_fill,
            control_mode=cfg.controlnet_control_mode,
            device_out=device_out,
            sheet_cache=sheet_cache,
        )

    def _remote_payload(self, original, rendered, mask, condition) -> dict:
        """The A1111 img2img request body (Euler a, the ControlNet always-on
        script with the depth model, the inpaint fields)."""
        from signerf_tpu_torch.utils.images import array_to_image, image_to_base64

        cfg = self.config
        payload = {
            "init_images": [image_to_base64(array_to_image(original))],
            "model": cfg.stable_diffusion_model,
            "init_latent_images": [image_to_base64(array_to_image(rendered))],
            "prompt": cfg.prompt,
            "steps": cfg.num_inference_steps,
            "cfg_scale": cfg.guidance_scale,
            "image_cfg_scale": cfg.image_guidance_scale,
            "height": int(original.shape[0]),
            "width": int(original.shape[1]),
            "denoising_strength": cfg.denoising_strength,
            "seed": cfg.seed,
            "sampler_name": "Euler a",
            "alwayson_scripts": {
                "controlnet": {
                    "args": [
                        {
                            "enabled": True,
                            "input_image": None if condition is None else image_to_base64(array_to_image(condition)),
                            "model": cfg.controlnet_model,
                            "module": "none",
                            "weight": cfg.controlnet_conditioning_scale,
                            "guidance_start": cfg.controlnet_conditioning_scale_start,
                            "guidance_end": cfg.controlnet_conditioning_scale_end,
                            "lowvram": cfg.controlnet_lowvram,
                            "control_mode": cfg.controlnet_control_mode,
                        }
                    ]
                }
            },
        }
        if mask is not None:
            payload["mask"] = image_to_base64(array_to_image(mask))
            payload["mask_blur"] = 4
            payload["inpainting_fill"] = 1
            payload["inpaint_full_res"] = 0
            payload["inpaint_full_res_padding"] = 32
        return payload

    def _diffuse_remote(self, original, rendered, mask, condition) -> np.ndarray:
        cfg = self.config
        url = f"{cfg.url}:{cfg.port}"
        payload = self._remote_payload(original, rendered, mask, condition)
        try:
            import requests

            req = requests.post(
                f"{url}/sdapi/v1/img2img",
                headers={"accept": "application/json", "Content-Type": "application/json"},
                data=json.dumps(payload),
                timeout=9999,
            )
            res = req.json()
        except Exception as exc:  # connection failure -> the original image
            print(f"[diffuser] could not reach SD Web UI at {url}: {exc}; returning the original image")
            return np.asarray(original)

        assert "images" in res, f"Images not found in response: {res}"
        from PIL import Image

        from signerf_tpu_torch.utils.images import base64_to_image, image_to_array

        img = base64_to_image(res["images"][0])
        img = img.resize((original.shape[1], original.shape[0]), Image.Resampling.LANCZOS)
        return image_to_array(img)[..., :3]
