"""Rank workers of the port's tensor-parallel tests (tests/test_torch_tensor_parallel.py):
the tiny SDXL's UNet + ControlNet forward, a 2-step `img2img` and the
generator's per-view loop, each on every rank of a `DataMesh` with a
tensor group, the SDXL sharded over it.

This module imports torch and the port only: spawned ranks re-import it by
name, and no JAX may enter them. Everything a worker needs (the whole
weights as a `{component: state_dict}`, inputs, configs) comes in its
arguments.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from signerf_tpu_torch.diffusion import sdxl_pipeline as tsdxl
from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
from signerf_tpu_torch.generator import datasetgenerator as tgen
from signerf_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_parallel_helpers import forbidden_modules, port_render


def tiny_pipeline(mesh: Optional[mesh_lib.DataMesh], state) -> tsdxl.SDXLInpaintPipeline:
    """The tiny SDXL on the CPU with the whole `state`, as `mesh`'s rank
    holds it (its tensor shards), or whole without a mesh."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # RANDOM-INIT: the weights come next
        pipe = tsdxl.SDXLInpaintPipeline.create(config=tsdxl.TINY_SDXL_CONFIG, device="cpu", mesh=mesh)
    pipe.load_state_dicts(state)
    return pipe


def eps(pipe: tsdxl.SDXLInpaintPipeline, case: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The ControlNet's residuals and the UNet's eps with them scaled by 0.8
    (one CFG branch as the pipeline runs it), on `case`'s inputs."""
    x, cond, t, ctx, pooled, tids = (torch.from_numpy(np.ascontiguousarray(a)) for a in case["inputs"])
    with torch.no_grad():
        down, mid = pipe.controlnet(x, cond, t, ctx, pooled, tids)
        s = torch.tensor(0.8)
        out = pipe.unet(x, t, ctx, pooled, tids, [r.float() * s for r in down], mid.float() * s)
    return {"eps": out, "mid": mid.float(), "down0": down[0].float()}


def img2img(pipe: tsdxl.SDXLInpaintPipeline, case: Dict[str, Any]) -> np.ndarray:
    return pipe.img2img(case["image"], "a chair", mask=case["mask"], control_image=case["depth"], num_steps=2,
                        seed=3)


def generate(mesh: Optional[mesh_lib.DataMesh], pipe: tsdxl.SDXLInpaintPipeline, case: Dict[str, Any]) -> str:
    """`generate_dataset` with the analytic sphere render and the tiny SDXL
    in process (2 steps), into `case["path"]`; returns the dataset directory."""
    cfg = tgen.DatasetGeneratorConfig(path=Path(case["path"]), diffuser=DiffuserConfig(num_inference_steps=2),
                                      **case["config"])
    gen = tgen.DatasetGenerator(cfg, np.eye(4)[:3], 1.0, lambda p: p, port_render,
                                diffuser=Diffuser(cfg.diffuser, device="cpu", pipeline=pipe, mesh=mesh),
                                device="cpu", mesh=mesh)
    return str(gen.generate_dataset(reference_camera_to_worlds=case["references"],
                                    synthetic_camera_to_worlds=case["views"]))


def suite(mesh: mesh_lib.DataMesh, case: Dict[str, Any], out: str) -> int:
    """Every tensor-parallel case on this rank; rank r saves its results,
    its shards' shapes, its launches and its imported modules to
    `out`/tp_rank{r}.pt."""
    torch.set_num_threads(1)
    pipe = tiny_pipeline(mesh, case["state"])
    results = {
        "eps": eps(pipe, case),
        "img2img": img2img(pipe, case),
        "dataset": generate(mesh, pipe, case["generate"]),
        "shapes": {comp: {k: tuple(v.shape) for k, v in getattr(pipe, comp).state_dict().items()}
                   for comp in ("unet", "controlnet")},
        "sharded_bytes": sum(t.numel() * t.element_size() for t in pipe.tensors(sharded=True)),
        "replicated_bytes": sum(t.numel() * t.element_size() for t in pipe.tensors(sharded=False)),
        "tensor": (mesh.tensor, mesh.tensor_rank, mesh.view_group, mesh.view_groups),
        "modules": forbidden_modules(),
        "backend": mesh.backend,
    }
    torch.save(results, Path(out) / f"tp_rank{mesh.rank}.pt")
    return 0
