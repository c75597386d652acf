"""The training step and the chunked full-image eval renderer.

Port of `signerf_tpu/engine/train_step.py`. A step samples pixel indices on
the images' device, generates their rays (no aabb: the model's near/far
planes), runs the forward and the losses, backpropagates (through K2 on the
card), gates the proposal gradients, and takes the optimizer step. The JAX
package's `lax.scan`s become plain loops: over micro-batches (gradient
accumulation) and over `steps_per_call` steps.

With a `DataMesh` (`signerf_tpu_torch/parallel/mesh.py`) training is
data-parallel over rays, as the JAX package's `shard_map` step: each rank
samples its share of the global batch with its own generator, and one
all-reduce a step averages the gradients and the metrics; the eval render
splits a frame's chunks over the ranks and assembles the frame on each.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, Optional

import torch

from signerf_tpu_torch.cameras.cameras import Cameras, RayBundle
from signerf_tpu_torch.data.pixel_samplers import (
    gather_pixels,
    sample_patches,
    sample_pixels,
    sample_pixels_masked,
)
from signerf_tpu_torch.engine import chunk_graph
from signerf_tpu_torch.utils import tracing

if TYPE_CHECKING:
    from signerf_tpu_torch.parallel.mesh import DataMesh

EVAL_OUTPUTS = ("rgb", "depth", "expected_depth", "accumulation")


@dataclasses.dataclass
class SamplerSettings:
    """Sampling knobs of one optimizer step."""

    num_rays: int = 4096
    patch_size: int = 1  # > 1: patch sampling
    use_mask: bool = False  # a mask forces plain pixel sampling
    micro_batches: int = 1  # gradient-accumulation splits per step


def _sample_indices(
    generator: torch.Generator,
    settings: SamplerSettings,
    num_images: int,
    height: int,
    width: int,
    mask_indices: Optional[torch.Tensor],
) -> torch.Tensor:
    if settings.use_mask and mask_indices is not None:
        return sample_pixels_masked(generator, settings.num_rays, mask_indices)
    if settings.patch_size > 1:
        return sample_patches(
            generator, settings.num_rays, settings.patch_size, num_images, height, width
        )
    return sample_pixels(generator, settings.num_rays, num_images, height, width)


def default_loss_fn(model, outputs, batch):
    ld = model.loss_dict(outputs, batch)
    # summed in key order, as jax.tree_util.tree_leaves orders a dict
    return sum(ld[k] for k in sorted(ld)), ld


def make_train_step(
    model: torch.nn.Module,
    optimizer,
    cameras: Cameras,
    settings: SamplerSettings,
    loss_fn: Optional[Callable] = None,
    steps_per_call: int = 1,
    mesh: Optional["DataMesh"] = None,
):
    """Returns ``fn(step, images_u8, mask_indices, generator) -> metrics``.

    ``images_u8`` is [N, H, W, 3] uint8 on the model's device; ``generator``
    draws the pixel indices and the sampling jitter on that device (None is
    the deterministic sampling, for tests that supply the indices). Runs
    `steps_per_call` optimizer steps from `step` on and returns the last
    one's metrics as device scalars (reading them syncs the device).

    With `mesh`, `settings.num_rays` is the global batch: each rank samples
    num_rays / W rays in max(1, micro_batches / W) micro-batches, and the
    gradients (after the micro-batch average and the proposal gate), the
    total loss, the loss terms and the MSE are averaged over the ranks in
    one all-reduce before the optimizer step and the PSNR. Every rank
    passes its own `generator`.
    """
    num_images = len(cameras)
    height, width = cameras.height, cameras.width
    loss_fn = loss_fn or default_loss_fn
    if mesh is not None:
        w = mesh.world_size
        if settings.num_rays % w:
            raise ValueError(f"the global num_rays={settings.num_rays} does not split over {w} ranks")
        settings = dataclasses.replace(
            settings, num_rays=settings.num_rays // w, micro_batches=max(1, settings.micro_batches // w)
        )
    micro = max(1, int(settings.micro_batches))
    if settings.num_rays % micro:
        raise ValueError(f"num_rays={settings.num_rays} does not split into {micro} micro-batches")
    if settings.patch_size > 1 and not settings.use_mask:
        if (settings.num_rays // micro) % (settings.patch_size**2):
            raise ValueError("micro-batches must hold whole patches")
    mcfg = model.config
    gated = getattr(mcfg, "proposal_update_every", 1) > 1
    proposal_params = [p for n, p in model.named_parameters() if n.startswith("proposal")]

    def single_step(step: int, images_u8, mask_indices, generator):
        if generator is not None and generator.device.type != images_u8.device.type:
            raise ValueError(
                f"the generator is on {generator.device}, the images on {images_u8.device}: "
                "pixels are sampled where the images are"
            )
        with tracing.span("data.sample", stream=True):
            idx = _sample_indices(generator, settings, num_images, height, width, mask_indices)
            rb = cameras.generate_rays_at(idx)
            target = gather_pixels(images_u8, idx).float() / 255.0
        anneal = model.anneal(step)
        with tracing.span("engine.optimizer", stream=True):
            optimizer.zero_grad()
        total = mse = 0.0
        ld_sum: Dict[str, torch.Tensor] = {}
        size = settings.num_rays // micro
        for i in range(micro):
            part = slice(i * size, (i + 1) * size)
            rb_i = rb.map(lambda x: x[part])
            batch = {"image": target[part], "indices": idx[part]}
            with tracing.span("models.forward", stream=True):
                outputs = model(rb_i, generator, train=True, anneal=anneal)
                with tracing.span("models.loss"):
                    tot, ld = loss_fn(model, outputs, batch)
            with tracing.span("engine.backward", stream=True):
                tot.backward()
            total = total + tot.detach()
            for k, v in ld.items():
                ld_sum[k] = ld_sum.get(k, 0.0) + v.detach()
            mse = mse + ((outputs["rgb"].detach() - target[part]) ** 2).mean()
        with tracing.span("engine.optimizer", stream=True):
            if micro > 1:
                inv = 1.0 / micro
                with torch.no_grad():
                    for p in model.parameters():
                        if p.grad is not None:
                            p.grad.mul_(inv)
                total, mse = total * inv, mse * inv
                ld_sum = {k: v * inv for k, v in ld_sum.items()}
            # Proposal throttling: every step during warmup, then every
            # `proposal_update_every` steps. Off-schedule grads are zeroed, and
            # Adam still steps on them, as in the JAX package.
            if gated and not (step < mcfg.proposal_warmup or step % mcfg.proposal_update_every == 0):
                with torch.no_grad():
                    for p in proposal_params:
                        if p.grad is not None:
                            p.grad.mul_(0.0)
            if mesh is not None:
                with tracing.span("parallel.all_mean"):
                    total, mse, ld_sum = _all_mean_step(mesh, model, total, mse, ld_sum)
            optimizer.step()
        metrics = dict(ld_sum)
        metrics["total_loss"] = total
        metrics["psnr"] = -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
        return metrics

    def train_fn(step: int, images_u8, mask_indices, generator):
        for i in range(steps_per_call):
            with tracing.span("engine.step"):
                metrics = single_step(step + i, images_u8, mask_indices, generator)
        return metrics

    return train_fn


def _all_mean_step(mesh: "DataMesh", model: torch.nn.Module, total, mse, ld_sum):
    """Average every gradient and the step's metrics over the ranks with one
    all-reduce of one flat buffer; the gradients are copied back in place."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    names = sorted(ld_sum)
    scalars = [total, mse, *(ld_sum[k] for k in names)]
    with torch.no_grad():
        flat = torch.cat([*(g.reshape(-1).float() for g in grads),
                          torch.stack([torch.as_tensor(v, dtype=torch.float32, device=grads[0].device)
                                       for v in scalars])])
        mesh.all_mean_(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()
        out = flat[offset:]
    return out[0], out[1], {k: out[2 + i] for i, k in enumerate(names)}


def make_eval_render(
    model: torch.nn.Module, chunk_size: int = 1 << 15, mesh: Optional["DataMesh"] = None
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``render(ray_bundle_flat, appearance_mode=None) -> outputs``.

    The flat bundle is padded to a chunk multiple by repeating its last ray
    (the reference's static-shape rule, so every chunk has the same shape)
    and rendered chunk by chunk under `torch.inference_mode()`, with the
    deterministic eval sampling, into buffers of the frame's size. Outputs
    stay on the bundle's device. On a CUDA device each chunk replays the
    model's CUDA graph of one chunk (`engine/chunk_graph.py`); elsewhere it
    calls the model.

    With `mesh`, every rank calls `render` on the same bundle: the frame is
    padded to a multiple of chunk_size x W (JAX's quantum), rank r renders a
    contiguous block of chunks, and the frame is assembled on every rank.
    The chunks are the one-rank render's, so the frame is its bit for bit.
    """
    quantum = chunk_size * (1 if mesh is None else mesh.world_size)

    def render(bundle_flat: RayBundle, appearance_mode: Optional[str] = None) -> Dict[str, torch.Tensor]:
        n = bundle_flat.origins.shape[0]
        num_chunks = -(-n // quantum) * quantum // chunk_size
        pad = num_chunks * chunk_size - n
        bundle = bundle_flat.map(
            lambda x: torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x
        )
        mine = range(num_chunks) if mesh is None else range(num_chunks)[mesh.share(num_chunks)]
        parts: Dict[str, torch.Tensor] = {}
        with torch.inference_mode():
            with chunk_graph.chunk_forward(model, bundle, chunk_size, appearance_mode, EVAL_OUTPUTS) as forward:
                for i, c in enumerate(mine):
                    with tracing.span("render.chunk"):
                        out = forward(bundle.map(lambda x: x[c * chunk_size : (c + 1) * chunk_size]))
                        if not parts:
                            parts = {k: v.new_empty((len(mine) * chunk_size, *v.shape[1:])) for k, v in out.items()}
                        for k, v in out.items():
                            parts[k][i * chunk_size : (i + 1) * chunk_size] = v
            with tracing.span("render.assemble"):
                if mesh is None:
                    return {k: v[:n] for k, v in parts.items()}
                local = torch.cat([parts[k].float() for k in EVAL_OUTPUTS], dim=-1)
                frame = mesh.assemble(local, num_chunks * chunk_size, mine.start * chunk_size)[:n]
        widths = [parts[k].shape[-1] for k in EVAL_OUTPUTS]
        return {k: v.to(parts[k].dtype) for k, v in zip(EVAL_OUTPUTS, frame.split(widths, dim=-1))}

    return render
