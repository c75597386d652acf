"""Diffusers checkpoints -> the port's state dicts (the full SDXL name map).

A copy of the name map of `signerf_tpu/diffusion/weight_conversion.py`
(which the port does not import), pointed at the port's parameter names.
The port's modules carry the flax paths joined by dots
(`core.down_1_attn_0.blocks_0.attn1.to_q.kernel`), so a port key split at
the dots is the flax path the map was written for. Components are the
diffusers SDXL base 1.0 checkpoints: `UNet2DConditionModel`,
`ControlNetModel`, `AutoencoderKL`, `CLIPTextModel(WithProjection)`.

Layout transforms, diffusers -> port:
  * Conv2d  : [O, I, kh, kw] -> the same (the port convolves with F.conv2d)
  * Linear  : [O, I]         -> [I, O] (the port keeps flax's Dense layout)
  * Embed, norms, position embedding: as is (`weight` -> `embedding`,
    `scale`, `position_embedding`)

Every port parameter must be matched by exactly one diffusers tensor of the
right shape; `convert_component` raises with the miss list otherwise.
Tensors may be torch tensors or numpy arrays.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# path translation
# ---------------------------------------------------------------------------


def _resnet(tname: str, leaf_parent: str) -> str:
    sub = {
        "norm1": "norm1",
        "conv1": "conv1",
        "time_emb_proj": "time_emb_proj",
        "norm2": "norm2",
        "conv2": "conv2",
        "conv_shortcut": "conv_shortcut",
    }[leaf_parent]
    return f"{tname}.{sub}"


def _transformer(tname: str, rest: List[str]) -> str:
    # rest like ["blocks_0", "attn1", "to_q"] or ["blocks_0", "ff_geglu",
    # "proj"] / ["blocks_0", "ff_out"] / ["blocks_0", "norm1"] or
    # ["norm"] / ["proj_in"] / ["proj_out"]
    head = rest[0]
    if head == "norm":
        return f"{tname}.norm"
    if head in ("proj_in", "proj_out"):
        return f"{tname}.{head}"
    k = int(head.split("_")[1])
    base = f"{tname}.transformer_blocks.{k}"
    sub = rest[1]
    if sub in ("norm1", "norm2", "norm3"):
        return f"{base}.{sub}"
    if sub in ("attn1", "attn2"):
        proj = rest[2]
        if proj == "to_out":
            return f"{base}.{sub}.to_out.0"
        return f"{base}.{sub}.{proj}"
    if sub == "ff_geglu":
        return f"{base}.ff.net.0.proj"
    if sub == "ff_out":
        return f"{base}.ff.net.2"
    raise KeyError(f"unknown transformer sub-path {rest}")


def unet_torch_name(path: List[str]) -> str:
    """flax param path (without trailing kernel/bias/scale) -> torch module."""
    p = path[0] if path[0] != "core" else None
    parts = path[1:] if p is None else path
    head = parts[0]
    m = re.match(r"down_(\d+)_res_(\d+)", head)
    if m:
        return _resnet(
            f"down_blocks.{m[1]}.resnets.{m[2]}", parts[1]
        )
    m = re.match(r"down_(\d+)_attn_(\d+)", head)
    if m:
        return _transformer(f"down_blocks.{m[1]}.attentions.{m[2]}", parts[1:])
    m = re.match(r"down_(\d+)_downsample", head)
    if m:
        return f"down_blocks.{m[1]}.downsamplers.0.conv"
    m = re.match(r"up_(\d+)_res_(\d+)", head)
    if m:
        return _resnet(f"up_blocks.{m[1]}.resnets.{m[2]}", parts[1])
    m = re.match(r"up_(\d+)_attn_(\d+)", head)
    if m:
        return _transformer(f"up_blocks.{m[1]}.attentions.{m[2]}", parts[1:])
    m = re.match(r"up_(\d+)_upsample", head)
    if m:
        return f"up_blocks.{m[1]}.upsamplers.0.conv"
    fixed = {
        "conv_in": "conv_in",
        "conv_out": "conv_out",
        "conv_norm_out": "conv_norm_out",
        "time_embed_1": "time_embedding.linear_1",
        "time_embed_2": "time_embedding.linear_2",
        "add_embed_1": "add_embedding.linear_1",
        "add_embed_2": "add_embedding.linear_2",
        "mid_res_1": None,
        "mid_res_2": None,
        "mid_attn": None,
    }
    if head == "mid_res_1":
        return _resnet("mid_block.resnets.0", parts[1])
    if head == "mid_res_2":
        return _resnet("mid_block.resnets.1", parts[1])
    if head == "mid_attn":
        return _transformer("mid_block.attentions.0", parts[1:])
    if head in fixed and fixed[head]:
        return fixed[head]
    raise KeyError(f"unmapped unet path {path}")


def controlnet_torch_name(path: List[str]) -> str:
    head = path[0]
    m = re.match(r"zero_conv_(\d+)", head)
    if m:
        return f"controlnet_down_blocks.{m[1]}"
    if head == "zero_conv_mid":
        return "controlnet_mid_block"
    if head == "cond_conv_in":
        return "controlnet_cond_embedding.conv_in"
    if head == "cond_conv_out":
        return "controlnet_cond_embedding.conv_out"
    m = re.match(r"cond_block_(\d+)", head)
    if m:
        return f"controlnet_cond_embedding.blocks.{m[1]}"
    return unet_torch_name(path)


def vae_torch_name(path: List[str]) -> str:
    comp = path[0]  # encoder | decoder
    parts = path[1:]
    head = parts[0]
    if comp == "encoder" and head == "quant_conv":
        return "quant_conv"
    if comp == "decoder" and head == "post_quant_conv":
        return "post_quant_conv"
    m = re.match(r"down_(\d+)_res_(\d+)", head)
    if m:
        return f"{comp}.down_blocks.{m[1]}.resnets.{m[2]}.{parts[1]}"
    m = re.match(r"down_(\d+)_downsample", head)
    if m:
        return f"{comp}.down_blocks.{m[1]}.downsamplers.0.conv"
    m = re.match(r"up_(\d+)_res_(\d+)", head)
    if m:
        return f"{comp}.up_blocks.{m[1]}.resnets.{m[2]}.{parts[1]}"
    m = re.match(r"up_(\d+)_upsample", head)
    if m:
        return f"{comp}.up_blocks.{m[1]}.upsamplers.0.conv"
    if head in ("mid_res_1", "mid_res_2"):
        idx = 0 if head == "mid_res_1" else 1
        return f"{comp}.mid_block.resnets.{idx}.{parts[1]}"
    if head == "mid_attn":
        sub = parts[1]
        if sub == "to_out":
            sub = "to_out.0"
        return f"{comp}.mid_block.attentions.0.{sub}"
    if head in ("conv_in", "conv_out", "conv_norm_out"):
        return f"{comp}.{head}"
    raise KeyError(f"unmapped vae path {path}")


def clip_torch_name(path: List[str]) -> str:
    head = path[0]
    if head == "token_embedding":
        return "text_model.embeddings.token_embedding"
    if head == "position_embedding":
        return "text_model.embeddings.position_embedding"
    if head == "final_layer_norm":
        return "text_model.final_layer_norm"
    if head == "text_projection":
        return "text_projection"
    m = re.match(r"layers_(\d+)", head)
    if m:
        base = f"text_model.encoder.layers.{m[1]}"
        sub = path[1]
        if sub == "self_attn":
            return f"{base}.self_attn.{path[2]}"
        if sub in ("layer_norm1", "layer_norm2"):
            return f"{base}.{sub}"
        if sub in ("fc1", "fc2"):
            return f"{base}.mlp.{sub}"
    raise KeyError(f"unmapped clip path {path}")


_NAME_FNS = {
    "unet": unet_torch_name,
    "controlnet": controlnet_torch_name,
    "vae": vae_torch_name,
    "clip_l": clip_torch_name,
    "clip_g": clip_torch_name,
}


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


def _torch_key(component: str, path: Tuple[str, ...]) -> Tuple[str, str]:
    """port path -> (diffusers key, transform kind)."""
    *mods, leaf = path
    name_fn = _NAME_FNS[component]
    if leaf == "kernel":
        return f"{name_fn(list(mods))}.weight", "kernel"
    if leaf == "bias":
        return f"{name_fn(list(mods))}.bias", "as_is"
    if leaf in ("scale", "embedding"):
        return f"{name_fn(list(mods))}.weight", "as_is"
    if leaf == "position_embedding":
        return f"{name_fn(list(mods) + [leaf])}.weight", "as_is"
    raise KeyError(f"unknown leaf {leaf} at {path}")


def _shapes(target) -> Dict[str, Tuple[int, ...]]:
    """A module (parameters may be on the meta device) or a state dict ->
    {port key: shape}."""
    sd = target.state_dict() if isinstance(target, torch.nn.Module) else target
    return {k: tuple(v.shape) for k, v in sd.items()}


def expected_torch_keys(component: str, target) -> Dict[str, Tuple[str, str]]:
    """{diffusers key: (port key, kind)} for a component's module or state dict."""
    out = {}
    for key in _shapes(target):
        tkey, kind = _torch_key(component, tuple(key.split(".")))
        out[tkey] = (key, kind)
    return out


def _transform(value, kind: str, target_shape) -> torch.Tensor:
    arr = torch.as_tensor(np.asarray(value, dtype=np.float32))
    if kind == "kernel" and arr.dim() == 2:  # linear [O, I] -> [I, O]
        arr = arr.T.contiguous()
    if tuple(arr.shape) != tuple(target_shape):
        raise ValueError(f"shape mismatch after transform: {tuple(arr.shape)} vs {tuple(target_shape)}")
    return arr


def convert_component(component: str, target, torch_sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A diffusers state dict -> the port's state dict for `target` (the
    component's module or a state dict of the right shapes), f32. Raises
    with a miss list if a port parameter has no source tensor."""
    out, misses = {}, []
    for key, shape in _shapes(target).items():
        tkey, kind = _torch_key(component, tuple(key.split(".")))
        if tkey not in torch_sd:
            misses.append(f"{key} <- {tkey}")
            continue
        out[key] = _transform(torch_sd[tkey], kind, shape)
    if misses:
        raise KeyError(f"{component}: {len(misses)} unmatched params, e.g.:\n  " + "\n  ".join(misses[:20]))
    return out


def convert_all(targets: Mapping[str, Any], torch_sds: Mapping[str, Mapping[str, Any]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Convert every component ({unet, controlnet, vae, clip_l, clip_g});
    `targets` maps each to its module (e.g. `SDXLInpaintPipeline.build_modules`
    under the meta device) or state dict."""
    return {comp: convert_component(comp, targets[comp], torch_sds[comp]) for comp in targets}
