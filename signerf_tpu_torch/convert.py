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
rename by path, and conv kernels from HWIO to OIHW. `load_sdxl_from_jax_`
copies such a tree straight into the modules one leaf at a time (each
leaf cast to its parameter's device and dtype), for trees as large as the
full SDXL's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from signerf_tpu_torch.ops.lpips import LPIPSParams, from_hwio


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (the JAX params tree, as numpy) -> flat
    {dotted name: f32 tensor}."""
    return {name: torch.from_numpy(np.array(val, dtype=np.float32)) for name, val in _leaves(params)}


def _leaves(node: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) of a nested dict, depth first in its order."""
    for key, val in node.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


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


SDXL_COMPONENTS = ("unet", "controlnet", "vae", "clip_l", "clip_g")


def _sdxl_leaves(params: Mapping[str, Any]) -> Iterator[Tuple[str, str, torch.Tensor]]:
    """(component, the port's name, tensor) for each leaf of the JAX SDXL
    params: tensors as given (views stay views), numpy or jax arrays as f32
    tensors, conv kernels permuted from HWIO to OIHW (a view)."""
    for comp in SDXL_COMPONENTS:
        for name, val in _leaves(params[comp]):
            t = val if isinstance(val, torch.Tensor) else torch.from_numpy(np.array(val, dtype=np.float32))
            if name.endswith("kernel") and t.dim() == 4:
                t = t.permute(3, 2, 0, 1)
            yield comp, name, t


def sdxl_from_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX SDXL pipeline's params (`{unet, controlnet, vae, clip_l,
    clip_g}`, arrays as numpy) -> `{component: state_dict}` of the port's
    `SDXLInpaintPipeline` (f32 tensors; loading casts them to the modules'
    bf16). Dense kernels keep flax's [in, out] layout; conv kernels go from
    HWIO to `F.conv2d`'s OIHW."""
    out: Dict[str, Dict[str, torch.Tensor]] = {comp: {} for comp in SDXL_COMPONENTS}
    for comp, name, t in _sdxl_leaves(params):
        out[comp][name] = torch.empty(t.shape, dtype=torch.float32).copy_(t)
    return out


@torch.no_grad()
def load_sdxl_from_jax_(modules: Mapping[str, torch.nn.Module], params: Mapping[str, Any]) -> None:
    """Copy the JAX SDXL pipeline's params (`{unet, controlnet, vae,
    clip_l, clip_g}`, leaves as tensors, for example read-only views from
    `engine.checkpoints.msgpack_restore_file`, or numpy arrays) into the
    port's modules of those names, leaf by leaf: each leaf goes to its
    parameter's device and dtype in one copy, so no converted copy of the
    tree is ever built. Strict, as `load_state_dict(strict=True)`: every
    name on both sides, same shapes."""
    targets = {comp: modules[comp].state_dict() for comp in SDXL_COMPONENTS}
    seen = {comp: set() for comp in SDXL_COMPONENTS}
    for comp, name, src in _sdxl_leaves(params):
        if name not in targets[comp]:
            raise KeyError(f"{comp}: unexpected parameter {name!r}")
        if tuple(src.shape) != tuple(targets[comp][name].shape):
            raise ValueError(f"{comp}.{name}: shape {tuple(src.shape)}, expected {tuple(targets[comp][name].shape)}")
        targets[comp][name].copy_(src)
        seen[comp].add(name)
    for comp in SDXL_COMPONENTS:
        missing = sorted(set(targets[comp]) - seen[comp])
        if missing:
            raise KeyError(f"{comp}: missing parameters {missing[:5]} ({len(missing)} in all)")
