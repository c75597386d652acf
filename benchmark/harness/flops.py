"""FLOP counts of the nerfacto render and train paths, frozen.

A copy of `signerf_tpu_torch/ops/flops.py`'s `nerfacto_flops` that reads
the widths from a configuration file of this benchmark instead of the
program's classes. Conventions: a multiply-add is 2 FLOPs, a GEMM
[M, K] x [K, N] is 2 M K N, the train path counts the forward three times.
Tensor-core work (bf16): the 2-layer density MLPs that run inside the fused
density kernels. CUDA-core work (f32): the encode's taps (3 a feature, level
and axis) and products (2 a feature and level), and every Dense layer
outside the kernels. The gradient normals' contraction (K5, K6) and LPIPS
are not counted, so a share of peak made from these counts is a lower
bound.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


def resolutions(num_levels: int, base_res: int, max_res: int) -> Tuple[int, ...]:
    """The factor grid's per-level resolutions (geometric from base to max)."""
    if num_levels == 1:
        return (base_res,)
    g = math.exp((math.log(max_res) - math.log(base_res)) / (num_levels - 1))
    return tuple(int(round(base_res * g**lvl)) for lvl in range(num_levels))


def mlp_flops(dims: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def encode_flops(num_levels: int, feat: int) -> int:
    return num_levels * feat * (3 * 3 + 2)


@dataclasses.dataclass(frozen=True)
class PerRay:
    tc: int  # bf16 tensor-core FLOPs a ray, forward
    f32: int  # f32 FLOPs a ray, forward

    def seconds_at_peak(self, rays: float, train: bool, bf16_peak: float, f32_peak: float) -> float:
        k = 3 if train else 1
        return k * rays * (self.tc / bf16_peak + self.f32 / f32_peak)


def nerfacto_per_ray(model: Dict) -> PerRay:
    """Per-ray forward FLOPs of a configuration file's `model` section."""
    m = model
    f = m["field"]
    base_levels = f["factor_num_levels"]
    base_feat = f["factor_features_per_level"]
    geo = f["geo_feat_dim"]
    sh = f["sh_levels"] ** 2
    fused = m.get("use_fused_density", True)
    grad_normals = m["predict_normals"] and m["use_gradient_normals"]
    base_in_kernel = fused and not grad_normals
    base = mlp_flops([base_levels * base_feat, m["hidden_dim"], 1 + geo])
    head_in = sh + geo + (m["appearance_embed_dim"] if m["use_appearance_embedding"] else 0)
    heads = mlp_flops([head_in] + [m["hidden_dim_color"]] * (f["num_layers_color"] - 1) + [3])
    if m["predict_normals"]:
        heads += mlp_flops([geo + sh, f["pred_normals_hidden"], f["pred_normals_hidden"], 3])
    n_nerf = m["num_nerf_samples_per_ray"]
    tc = n_nerf * (base if base_in_kernel else 0)
    f32 = n_nerf * (encode_flops(base_levels, base_feat) + heads + (0 if base_in_kernel else base))
    pfeat = m["proposal_factor_features_per_level"]
    for n, args in zip(m["num_proposal_samples_per_ray"], m["proposal_net_args_list"]):
        enc = encode_flops(args["num_levels"], pfeat)
        if args.get("use_linear", False):
            f32 += n * (enc + mlp_flops([args["num_levels"] * pfeat, 1]))
        else:
            mlp = mlp_flops([args["num_levels"] * pfeat, args["hidden_dim"], 1])
            tc += n * (mlp if fused else 0)
            f32 += n * (enc + (0 if fused else mlp))
    return PerRay(tc=tc, f32=f32)
