"""JAX params <-> the port's `state_dict`, and JAX LPIPS params -> the port's.

The port's modules carry the flax names (`field.encoding.line_0_0`, or
`field.encoding.table` and `proposal_0.HashGridEncoding_0.table` with the
hash backend, `field.mlp_base.dense_0.kernel`,
`field.mlp_pred_normals.dense_2.bias`, `proposal_0.MLP_0.dense_1.bias`,
...), so a JAX `NerfactoModel.init` tree of either backend
maps onto `NerfactoModel.state_dict()` by joining the tree path with dots.
No tensor is transposed: the port keeps flax's [in, out] Dense kernel
layout (`factor_grid.dense_bf16` computes x @ kernel, and the CUDA kernels
read W0 [D, H] row by row), so the converter is a rename and a dtype check.

LPIPS is not part of either params tree (it is frozen): `lpips_from_jax`
turns a JAX `LPIPSParams` (as numpy) into the port's, HWIO conv kernels to
OIHW.

`sdxl_from_jax` does the same for the SDXL pipeline's five components: a
rename by path, and conv kernels from HWIO to OIHW.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from signerf_tpu_torch.ops.lpips import LPIPSParams, from_hwio


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (the JAX params tree, as numpy) -> flat
    {dotted name: f32 tensor}."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Mapping[str, Any]) -> None:
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(name + ".", val)
            else:
                out[name] = torch.from_numpy(np.array(val, dtype=np.float32))

    walk("", params)
    return out


def jax_params_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat {dotted name: tensor} -> nested dict of f32 numpy arrays."""
    out: Dict[str, Any] = {}
    for name, val in state_dict.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val.detach().cpu().float().numpy()
    return out


def lpips_from_jax(params: Any) -> LPIPSParams:
    """A JAX `signerf_tpu.ops.lpips.LPIPSParams` (its arrays as numpy or
    jax arrays) -> the port's `LPIPSParams`, f32, OIHW kernels."""
    return from_hwio(params.convs, params.lins, params.net)


def sdxl_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX SDXL pipeline's params (`{unet, controlnet, vae, clip_l,
    clip_g}`, arrays as numpy) -> `{component: state_dict}` of the port's
    `SDXLInpaintPipeline` (f32 tensors; loading casts them to the modules'
    bf16). Dense kernels keep flax's [in, out] layout; conv kernels go from
    HWIO to `F.conv2d`'s OIHW."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for comp in ("unet", "controlnet", "vae", "clip_l", "clip_g"):
        sd = state_dict_from_jax(params[comp])
        for name, val in sd.items():
            if name.endswith("kernel") and val.dim() == 4:
                sd[name] = val.permute(3, 2, 0, 1).contiguous()
        out[comp] = sd
    return out
