"""The reference train step: the same pixels and jitter as the program's
step (drawn from a generator in the state the benchmark hands both), the
forward, the losses and their gradient in float32, then Adam.

The batch is processed in blocks of whole patches so that it fits: every
loss is a mean over rays (LPIPS over patches), so the blocks' means
weighted by their share of the batch give the batch's loss and gradient.
A data-parallel step is the mean over its ranks' batches.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import nerf


def sample_indices(generator: torch.Generator, num_rays: int, patch: int, num_images: int, height: int,
                   width: int) -> torch.Tensor:
    """[N, 3] (camera, y, x): random whole patches, patch-major and row-major
    inside a patch; single pixels when `patch` is 1."""
    dev = generator.device

    def randint(high: int, n: int) -> torch.Tensor:
        return torch.randint(0, high, (n,), generator=generator, device=dev)

    if patch == 1:
        cam, ys, xs = randint(num_images, num_rays), randint(height, num_rays), randint(width, num_rays)
        return torch.stack([cam, ys, xs], dim=-1)
    n = num_rays // (patch * patch)
    cam = randint(num_images, n)
    y0 = randint(max(height - patch, 1), n)
    x0 = randint(max(width - patch, 1), n)
    dy, dx = torch.meshgrid(torch.arange(patch, device=dev), torch.arange(patch, device=dev), indexing="ij")
    ys, xs = y0[:, None, None] + dy, x0[:, None, None] + dx
    return torch.stack([cam[:, None, None].expand(ys.shape), ys, xs], dim=-1).reshape(-1, 3)


def train_step(params: Dict[str, torch.Tensor], adam: nerf.Adam, step: int, generator_states: List[torch.Tensor],
               scene, model: Dict, num_rays: int, patch: int, lpips_params, prec: nerf.Precision,
               block_rays: int) -> Tuple[float, Dict[str, torch.Tensor], List[torch.Tensor]]:
    """One optimizer step on `params` (updated in place), data-parallel over
    as many ranks as `generator_states` holds: each rank draws `num_rays`
    rays from its generator, the step's loss and gradient are the ranks'
    means. Returns the loss, the gradient Adam was given and each rank's
    generator state after its draws."""
    dev = scene.images.device
    n_img, size = scene.images.shape[0], scene.images.shape[1]
    if not model["single_jitter"]:
        raise ValueError("the reference draws one jitter a ray (single_jitter)")
    a = nerf.anneal(model, step)
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    total = 0.0
    after = []
    ranks = len(generator_states)
    for state in generator_states:
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        idx = sample_indices(gen, num_rays, patch, n_img, size, size)
        jitters = [torch.rand((idx.shape[0], 1), generator=gen, device=dev)
                   for _ in range(model["num_proposal_iterations"] + 1)]
        after.append(gen.get_state())
        origins, dirs, cam = nerf.rays_at(scene.poses, scene.focal, size, idx)
        target = scene.images[idx[:, 0], idx[:, 1], idx[:, 2]].float() / 255.0
        r = idx.shape[0]
        near = torch.full((r, 1), model["near_plane"], device=dev)
        far = torch.full((r, 1), model["far_plane"], device=dev)
        for start in range(0, r, block_rays):
            sl = slice(start, min(start + block_rays, r))
            share = (sl.stop - sl.start) / r / ranks
            out = nerf.forward(leaves, model, origins[sl], dirs[sl], cam[sl], near[sl], far[sl],
                               [j[sl] for j in jitters], a, True, prec)
            ld = nerf.losses(out, target[sl], model, lpips_params)
            loss = sum(ld[k] for k in sorted(ld)) * share
            got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            for n, g in zip(leaves, got):
                if g is not None:
                    grads[n] += g
            total += float(loss.detach())
            del out, ld, loss, got
    adam.step(params, grads)
    return total, grads, after


def render_rays(params: Dict[str, torch.Tensor], model: Dict, origins, dirs, near, far, prec: nerf.Precision,
                block_rays: int) -> Dict[str, torch.Tensor]:
    """The eval render of a flat ray batch in blocks (deterministic sampling,
    the mean appearance code): rgb, accumulation, expected depth."""
    keys = ("rgb", "accumulation", "expected_depth")
    parts = {k: [] for k in keys}
    cam = torch.zeros(origins.shape[0], dtype=torch.long, device=origins.device)
    with torch.no_grad():
        for start in range(0, origins.shape[0], block_rays):
            sl = slice(start, start + block_rays)
            out = nerf.forward(params, model, origins[sl], dirs[sl], cam[sl], near[sl], far[sl], None, 1.0, False,
                               prec)
            for k in keys:
                parts[k].append(out[k])
    return {k: torch.cat(v) for k, v in parts.items()}
