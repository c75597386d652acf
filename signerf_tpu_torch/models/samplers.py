"""Ray samplers: spaced (uniform-lindisp piecewise) and PDF (inverse CDF),
and nerfacto's two-level proposal sampling driver.

Port of `signerf_tpu/models/samplers.py`. Randomness comes from an explicit
`torch.Generator`; with none (the eval render) every sampler is
deterministic. The inverse-CDF lookup uses `torch.searchsorted` where the
reference avoided gathers on the TPU with an [R, Q, S+1] masked reduction;
the two give the same brackets because the CDF and the bins are both
nondecreasing along the samples.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from signerf_tpu_torch.cameras.cameras import RayBundle
from signerf_tpu_torch.models.ray_samples import RaySamples

# ---------------------------------------------------------------------------
# spacing functions (s-space <-> euclidean t-space)
# ---------------------------------------------------------------------------


def piecewise_fn(x: torch.Tensor) -> torch.Tensor:
    """Uniform in t for t < 1, linear in disparity beyond (mipnerf360)."""
    return torch.where(x < 1.0, x / 2.0, 1.0 - 1.0 / (2.0 * x.clamp_min(1e-12)))


def piecewise_fn_inv(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.5, 2.0 * x, 1.0 / (2.0 - 2.0 * x).clamp_min(1e-12))


def make_spacing(
    nears: torch.Tensor, fars: torch.Tensor
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Callable[[torch.Tensor], torch.Tensor]]:
    """(s_to_t, t_to_s) for per-ray [R, 1] near/far planes."""
    s_near = piecewise_fn(nears)
    s_far = piecewise_fn(fars)

    def s_to_t(s: torch.Tensor) -> torch.Tensor:
        return piecewise_fn_inv(s * s_far + (1.0 - s) * s_near)

    def t_to_s(t: torch.Tensor) -> torch.Tensor:
        return (piecewise_fn(t) - s_near) / (s_far - s_near).clamp_min(1e-12)

    return s_to_t, t_to_s


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def sample_uniform_bins(
    generator: Optional[torch.Generator],
    num_rays: int,
    num_samples: int,
    single_jitter: bool = True,
    device=None,
) -> torch.Tensor:
    """Stratified s-space bin edges [R, S+1] in [0, 1]."""
    edges = torch.linspace(0.0, 1.0, num_samples + 1, device=device)
    edges = edges.expand(num_rays, num_samples + 1)
    if generator is None:
        return edges
    cols = 1 if single_jitter else num_samples + 1
    jitter = torch.rand((num_rays, cols), generator=generator, device=device)
    return (edges + (jitter - 0.5) * (1.0 / num_samples)).clamp(0.0, 1.0)


def sample_pdf_bins(
    generator: Optional[torch.Generator],
    spacing_bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    histogram_padding: float = 0.01,
    single_jitter: bool = True,
) -> torch.Tensor:
    """Inverse-CDF resampling of s-space bins [R, S+1] by weights [R, S]
    -> new s-space bin edges [R, num_samples + 1]."""
    num_rays = weights.shape[0]
    device = weights.device
    weights = weights + histogram_padding
    weight_sum = weights.sum(-1, keepdim=True)
    padding = (1e-7 - weight_sum).clamp_min(0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), pdf.cumsum(-1)], dim=-1)
    cdf = cdf.clamp_max(1.0).contiguous()  # [R, S+1]

    s = num_samples + 1
    base = torch.linspace(0.0, 1.0 - 1.0 / s, s, device=device)[None, :]
    if generator is not None:
        cols = 1 if single_jitter else s
        u = base + torch.rand((num_rays, cols), generator=generator, device=device) / s
    else:
        u = (base + 0.5 / s).expand(num_rays, s)
    u = u.contiguous()

    # below: last index with cdf <= u; above: first index with cdf >= u.
    # The reference's masked max/min reductions pick the same entries.
    last = cdf.shape[-1] - 1
    below = torch.searchsorted(cdf, u, right=True) - 1
    above = torch.searchsorted(cdf, u, right=False)
    cdf_b = cdf.gather(-1, below.clamp(0, last))
    bins_b = spacing_bins.gather(-1, below.clamp(0, last))
    cdf_a = cdf.gather(-1, above.clamp(0, last))
    bins_a = spacing_bins.gather(-1, above.clamp(0, last))
    # Out-of-range fallbacks (u below cdf[0] / above cdf[-1]).
    cdf_b = torch.where(below >= 0, cdf_b, cdf[:, :1])
    bins_b = torch.where(below >= 0, bins_b, spacing_bins[:, :1])
    cdf_a = torch.where(above <= last, cdf_a, cdf[:, -1:])
    bins_a = torch.where(above <= last, bins_a, spacing_bins[:, -1:])

    diff = cdf_a - cdf_b
    denom = torch.where(diff < 1e-10, torch.ones_like(diff), diff)
    t = ((u - cdf_b) / denom).clamp(0.0, 1.0)
    new_bins = bins_b + t * (bins_a - bins_b)
    # Ascending up to float rounding; a running max restores monotonicity.
    return torch.cummax(new_bins, dim=-1).values


def bins_to_ray_samples(
    ray_bundle: RayBundle,
    spacing_bins: torch.Tensor,
    s_to_t: Callable[[torch.Tensor], torch.Tensor],
) -> RaySamples:
    """s-space bin edges [R, S+1] -> euclidean RaySamples."""
    euclidean = s_to_t(spacing_bins)
    cam_idx = None if ray_bundle.camera_indices is None else ray_bundle.camera_indices[..., 0]
    pix = None if ray_bundle.pixel_area is None else ray_bundle.pixel_area[..., 0]
    return RaySamples(
        origins=ray_bundle.origins,
        directions=ray_bundle.directions,
        starts=euclidean[..., :-1],
        ends=euclidean[..., 1:],
        spacing_starts=spacing_bins[..., :-1],
        spacing_ends=spacing_bins[..., 1:],
        camera_indices=cam_idx,
        pixel_area=pix,
    )


def render_weights(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Volumetric rendering weights from densities [R, S] and deltas [R, S]."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    excl = torch.cat(
        [torch.zeros_like(delta_density[..., :1]), delta_density[..., :-1].cumsum(-1)],
        dim=-1,
    )
    return alphas * torch.exp(-excl)


# ---------------------------------------------------------------------------
# proposal-network sampling driver
# ---------------------------------------------------------------------------


def proposal_sample(
    generator: Optional[torch.Generator],
    ray_bundle: RayBundle,
    density_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    num_proposal_samples: Sequence[int] = (256, 96),
    num_nerf_samples: int = 48,
    single_jitter: bool = True,
    anneal: float = 1.0,
):
    """Hierarchical proposal sampling (nerfacto semantics).

    Returns (ray_samples, weights_list, ray_samples_list); the lists hold
    each proposal level's annealed weights and samples, in order.
    """
    origins = ray_bundle.origins
    num_rays = origins.shape[0]
    nears = ray_bundle.nears
    if nears is None:
        nears = torch.full((num_rays, 1), 0.05, dtype=origins.dtype, device=origins.device)
    fars = ray_bundle.fars
    if fars is None:
        fars = torch.full((num_rays, 1), 1000.0, dtype=origins.dtype, device=origins.device)
    s_to_t, _ = make_spacing(nears, fars)

    weights_list = []
    samples_list = []
    bins = sample_uniform_bins(
        generator, num_rays, num_proposal_samples[0], single_jitter, device=origins.device
    )
    samples = bins_to_ray_samples(ray_bundle, bins, s_to_t)
    for i, density_fn in enumerate(density_fns):
        weights = render_weights(density_fn(samples.positions), samples.deltas)
        # w^anneal, with weights below the floor treated as 0 (the reference
        # needs that for a finite gradient at w = 0).
        floor = 1e-7
        annealed = torch.where(
            weights < floor, torch.zeros_like(weights), weights.clamp_min(floor).pow(anneal)
        )
        weights_list.append(annealed)
        samples_list.append(samples)
        n_next = (
            num_proposal_samples[i + 1] if i + 1 < len(num_proposal_samples) else num_nerf_samples
        )
        bins = sample_pdf_bins(
            generator, samples.spacing_bins, annealed.detach(), n_next, single_jitter=single_jitter
        )
        samples = bins_to_ray_samples(ray_bundle, bins, s_to_t)
    return samples, weights_list, samples_list
