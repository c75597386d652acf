"""The chunked full-image eval renderer.

Port of `make_eval_render` from `signerf_tpu/engine/train_step.py`; the
train step comes with the training slice.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from signerf_tpu_torch.cameras.cameras import RayBundle

EVAL_OUTPUTS = ("rgb", "depth", "expected_depth", "accumulation")


def make_eval_render(
    model: torch.nn.Module, chunk_size: int = 1 << 15
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``render(ray_bundle_flat) -> outputs``.

    The flat bundle is padded to a chunk multiple by repeating its last ray
    (the reference's static-shape rule, so every chunk has the same shape)
    and rendered chunk by chunk under `torch.inference_mode()`, with the
    deterministic eval sampling. Outputs stay on the bundle's device.
    """

    def render(bundle_flat: RayBundle) -> Dict[str, torch.Tensor]:
        n = bundle_flat.origins.shape[0]
        num_chunks = -(-n // chunk_size)
        pad = num_chunks * chunk_size - n
        bundle = bundle_flat.map(
            lambda x: torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x
        )
        parts = {k: [] for k in EVAL_OUTPUTS}
        with torch.inference_mode():
            for c in range(num_chunks):
                chunk = bundle.map(lambda x: x[c * chunk_size : (c + 1) * chunk_size])
                out = model(chunk)
                for k in EVAL_OUTPUTS:
                    parts[k].append(out[k])
        return {k: torch.cat(v)[:n] for k, v in parts.items()}

    return render
