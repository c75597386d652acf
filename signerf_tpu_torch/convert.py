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

`shard_sdxl_state` keeps a tensor rank's part of a whole
`{component: state_dict}` (the UNet's and the ControlNet's q, k, v, GEGLU
proj and to_out / ff_out leaves, by the rule of `diffusion/unet.py`'s
sharded blocks; `sdxl_shard` names each leaf's part), and
`unshard_sdxl_state` puts the ranks' parts together again.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from signerf_tpu_torch.diffusion.layers import Shard
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


SHARDED_COMPONENTS = ("unet", "controlnet")
SDXL_HEAD_DIM = 64


def sdxl_shard(component: str, name: str, shape: Sequence[int], rank: int, tensor: int,
               head_dim: int = SDXL_HEAD_DIM) -> Optional[Shard]:
    """Tensor rank `rank`'s part of the whole SDXL leaf `component.name` of
    `shape`, or None where every rank holds it whole: the q, k and v
    kernels' columns and the to_out kernel's rows of a block whose head
    count (columns / `head_dim`) `tensor` divides; GEGLU's proj kernel
    columns and bias, 1/T of each of its halves h and gate, and the ff_out
    kernel's rows, where `tensor` divides the FF width. These are the 700
    leaves of the full UNet that JAX's `tensor_parallel_pspecs` shards
    (its 1-D biases stay whole there, GEGLU's included; a rank here needs
    only its proj bias entries), and the ControlNet's."""
    from signerf_tpu_torch.diffusion.unet import TensorShard

    if component not in SHARDED_COMPONENTS or tensor == 1:
        return None
    tp = TensorShard(rank, tensor)
    layer, _, leaf = name.rpartition(".")
    layer = layer.rpartition(".")[2]
    if layer in ("to_q", "to_k", "to_v") and leaf == "kernel" and tp.divides(shape[1] // head_dim):
        return tp.shard(1, shape[1])
    if layer == "to_out" and leaf == "kernel" and tp.divides(shape[0] // head_dim):
        return tp.shard(0, shape[0])
    if name.endswith("ff_geglu.proj.kernel") and tp.divides(shape[1] // 2):
        return tp.shard(1, shape[1], blocks=2)
    if name.endswith("ff_geglu.proj.bias") and tp.divides(shape[0] // 2):
        return tp.shard(0, shape[0], blocks=2)
    if layer == "ff_out" and leaf == "kernel" and tp.divides(shape[0]):
        return tp.shard(0, shape[0])
    return None


def shard_sdxl_state(state: Mapping[str, Mapping[str, torch.Tensor]], rank: int, tensor: int,
                     head_dim: int = SDXL_HEAD_DIM) -> Dict[str, Dict[str, torch.Tensor]]:
    """A whole `{component: state_dict}` -> tensor rank `rank`'s (of
    `tensor`): each sharded leaf's part (`sdxl_shard`), every other leaf as
    it is."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for comp, sd in state.items():
        out[comp] = {}
        for name, t in sd.items():
            shard = sdxl_shard(comp, name, t.shape, rank, tensor, head_dim)
            out[comp][name] = t if shard is None else shard.take(t)
    return out


def unshard_sdxl_state(parts: Sequence[Mapping[str, Mapping[str, torch.Tensor]]],
                       shapes: Mapping[str, Mapping[str, Sequence[int]]],
                       head_dim: int = SDXL_HEAD_DIM) -> Dict[str, Dict[str, torch.Tensor]]:
    """The inverse of `shard_sdxl_state`: the ranks' states, in rank order,
    and the whole leaves' `shapes` -> the whole state (each leaf that no
    rank shards taken from rank 0)."""
    tensor = len(parts)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for comp, sd in parts[0].items():
        out[comp] = {}
        for name, t in sd.items():
            shape = tuple(shapes[comp][name])
            if sdxl_shard(comp, name, shape, 0, tensor, head_dim) is None:
                out[comp][name] = t
                continue
            whole = torch.empty(shape, dtype=t.dtype, device=t.device)
            for r, part in enumerate(parts):
                shard = sdxl_shard(comp, name, shape, r, tensor, head_dim)
                chunks = part[comp][name].split([b - a for a, b in shard.spans], shard.dim)
                for (a, b), chunk in zip(shard.spans, chunks):
                    whole.narrow(shard.dim, a, b - a).copy_(chunk)
            out[comp][name] = whole
    return out


@torch.no_grad()
def load_sdxl_from_jax_(modules: Mapping[str, torch.nn.Module], params: Mapping[str, Any], rank: int = 0,
                        tensor: int = 1, head_dim: int = SDXL_HEAD_DIM) -> None:
    """Copy the JAX SDXL pipeline's params (`{unet, controlnet, vae,
    clip_l, clip_g}`, leaves as tensors, for example read-only views from
    `engine.checkpoints.msgpack_restore_file`, or numpy arrays) into the
    port's modules of those names, leaf by leaf: each leaf goes to its
    parameter's device and dtype in one copy, so no converted copy of the
    tree is ever built. Strict, as `load_state_dict(strict=True)`: every
    name on both sides, same shapes. With `tensor` > 1 the modules are
    tensor rank `rank`'s, and each sharded leaf is cut to its part first."""
    targets = {comp: modules[comp].state_dict() for comp in SDXL_COMPONENTS}
    seen = {comp: set() for comp in SDXL_COMPONENTS}
    for comp, name, src in _sdxl_leaves(params):
        if name not in targets[comp]:
            raise KeyError(f"{comp}: unexpected parameter {name!r}")
        shard = sdxl_shard(comp, name, src.shape, rank, tensor, head_dim)
        if shard is not None:
            src = shard.take(src)
        if tuple(src.shape) != tuple(targets[comp][name].shape):
            raise ValueError(f"{comp}.{name}: shape {tuple(src.shape)}, expected {tuple(targets[comp][name].shape)}")
        targets[comp][name].copy_(src)
        seen[comp].add(name)
    for comp in SDXL_COMPONENTS:
        missing = sorted(set(targets[comp]) - seen[comp])
        if missing:
            raise KeyError(f"{comp}: missing parameters {missing[:5]} ({len(missing)} in all)")
