"""Diffusion schedule and the Euler-ancestral sampler with A1111 semantics
(the port of `signerf_tpu/diffusion/sampler.py`).

- The scaled-linear beta schedule, k-diffusion's `get_sigmas` and the
  img2img `strength_sigmas` are the JAX package's numpy code, copied.
- Scalar sigma arithmetic (`sigma_to_t`, `get_ancestral_step`) runs in
  numpy float32, as JAX runs it in f32; tensor arithmetic follows JAX's
  type promotion (a bf16 latent meeting an f32 sigma becomes f32).
- Every random draw comes from a `NoiseSource`: a callable
  `(name, step, shape, dtype) -> tensor` with name "init", "step",
  "renoise" or "fill". The pipeline's default draws from a seeded
  `torch.Generator`; the tests pass JAX's threefry draws in instead (the
  two generators never give the same numbers from one seed).
- `gaussian_blur` (separable, zero-padded) and `apply_fill_mode` are the
  A1111 inpaint preprocessing; `resize_linear_weights` builds the matrices
  of `jax.image.resize(..., "linear")`, which antialiases when it
  downsamples (a triangle kernel stretched by the scale, normalised per
  output pixel), so that the latent mask equals JAX's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NoiseSource = Callable[[str, int, Tuple[int, ...], torch.dtype], torch.Tensor]


def make_sd_schedule(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                     beta_end: float = 0.012) -> np.ndarray:
    """Return sigmas[t] (ascending in t) of the scaled-linear DDPM schedule."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    return np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)


def get_sigmas(num_steps: int, train_sigmas: Optional[np.ndarray] = None) -> np.ndarray:
    """k-diffusion sigma selection: t linspace(T-1, 0, n), log-sigma interp;
    appended 0. Returns [n+1] descending."""
    if train_sigmas is None:
        train_sigmas = make_sd_schedule()
    t_max = len(train_sigmas) - 1
    t = np.linspace(t_max, 0, num_steps)
    log_sigmas = np.log(train_sigmas)
    low_idx = np.floor(t).astype(int)
    high_idx = np.ceil(t).astype(int)
    w = t - low_idx
    log_s = (1 - w) * log_sigmas[low_idx] + w * log_sigmas[high_idx]
    sigmas = np.exp(log_s)
    return np.append(sigmas, 0.0).astype(np.float32)


def strength_sigmas(sigmas: np.ndarray, strength: float) -> np.ndarray:
    """img2img denoising-strength: keep the last t_enc+1 sigma entries
    (A1111: t_enc = min(int(strength * steps), steps - 1))."""
    steps = len(sigmas) - 1
    t_enc = min(int(strength * steps), steps)
    if t_enc <= 0:
        return sigmas[-1:]
    return sigmas[steps - t_enc :]


def sigma_to_t(sigma, train_sigmas: np.ndarray) -> np.float32:
    """Continuous timestep for a scalar sigma (log-sigma interpolation inverse), f32."""
    f32 = np.float32
    log_sigmas = np.log(train_sigmas).astype(f32)
    log_sigma = np.log(np.maximum(f32(sigma), f32(1e-10)))
    low = int(np.clip(np.sum(log_sigmas <= log_sigma) - 1, 0, len(train_sigmas) - 2))
    w = (log_sigma - log_sigmas[low]) / (log_sigmas[low + 1] - log_sigmas[low])
    w = np.clip(w, f32(0.0), f32(1.0))
    return (f32(1.0) - w) * f32(low) + w * f32(low + 1)


def get_ancestral_step(sigma_from, sigma_to) -> Tuple[np.float32, np.float32]:
    """k-diffusion `get_ancestral_step` (eta=1), f32."""
    f32 = np.float32
    s_from, s_to = f32(sigma_from), f32(sigma_to)
    var = s_to**2 * (s_from**2 - s_to**2) / np.maximum(s_from**2, f32(1e-20))
    sigma_up = np.minimum(s_to, np.sqrt(np.maximum(var, f32(0.0))))
    sigma_down = np.sqrt(np.maximum(s_to**2 - sigma_up**2, f32(0.0)))
    return f32(sigma_down), f32(sigma_up)


class InpaintSpec(NamedTuple):
    """Latent-space inpaint state: blend with the noised original outside
    the (latent) mask after every step."""

    init_latent: torch.Tensor  # [B, h, w, C] clean original latents
    latent_mask: torch.Tensor  # [B, h, w, 1], 1 = regenerate, 0 = keep


# denoised_fn(x, sigma, step_frac) -> denoised x0 prediction (CFG inside);
# step_frac = i / num_steps gates the ControlNet's start and end.
DenoisedFn = Callable[[torch.Tensor, np.float32, float], torch.Tensor]


def generator_noise(gen: torch.Generator, device) -> NoiseSource:
    """The default noise source: standard normals from `gen`, drawn in f32
    on `device` and rounded to the requested dtype."""

    def draw(name: str, step: int, shape, dtype) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device).to(dtype)

    return draw


def sample_euler_ancestral(
    noise: NoiseSource,
    denoised_fn: DenoisedFn,
    init_latent: torch.Tensor,  # [B, h, w, C] clean image latents (img2img)
    sigmas: np.ndarray,  # [n+1] f32 descending, last = 0
    inpaint: Optional[InpaintSpec] = None,
    step_callback: Optional[Callable[[int], None]] = None,
) -> torch.Tensor:
    """Euler-ancestral sampling from `init_latent + noise * sigmas[0]`;
    returns f32 latents. `step_callback(i)` runs after step i's update."""
    n = len(sigmas) - 1
    device = init_latent.device
    dev = lambda t: t.to(device)  # noqa: E731
    x = init_latent.float() + dev(noise("init", 0, init_latent.shape, init_latent.dtype)).float() * float(sigmas[0])
    for i in range(n):
        sigma, sigma_next = np.float32(sigmas[i]), np.float32(sigmas[i + 1])
        denoised = denoised_fn(x, sigma, float(np.float32(i) / np.float32(n)))
        sigma_down, sigma_up = get_ancestral_step(sigma, sigma_next)
        d = (x - denoised) / float(np.maximum(sigma, np.float32(1e-10)))
        x = x + d * float(sigma_down - sigma)
        step_noise = dev(noise("step", i, x.shape, torch.float32))
        if sigma_next > 0:
            x = x + step_noise * float(sigma_up)
        if inpaint is not None:
            # Re-noise the original to the next sigma and keep it outside
            # the mask (A1111 img2img latent mask path).
            renoise = dev(noise("renoise", i, x.shape, torch.float32))
            orig_noised = inpaint.init_latent + renoise * float(sigma_next)
            x = x * inpaint.latent_mask + orig_noised * (1.0 - inpaint.latent_mask)
        if step_callback is not None:
            step_callback(i)
    if inpaint is not None:
        x = x * inpaint.latent_mask + inpaint.init_latent * (1.0 - inpaint.latent_mask)
    return x


def cfg_mix(eps_uncond: torch.Tensor, eps_cond: torch.Tensor, scale) -> torch.Tensor:
    return eps_uncond + scale * (eps_cond - eps_uncond)


def eps_to_denoised(x: torch.Tensor, eps: torch.Tensor, sigma) -> torch.Tensor:
    """CompVis eps-parameterization: denoised = x - sigma * eps."""
    return x - float(sigma) * eps


def scale_model_input(x: torch.Tensor, sigma) -> torch.Tensor:
    """c_in scaling before the eps model: x / sqrt(sigma^2 + 1), f32."""
    s = np.float32(sigma)
    return x / float(np.sqrt(s * s + np.float32(1.0)))


def gaussian_blur(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable, zero-padded gaussian blur of [..., H, W, 1] with sigma ~
    radius / 2 (A1111 `mask_blur` uses PIL GaussianBlur(radius))."""
    if radius <= 0:
        return mask
    sigma = max(radius / 2.0, 0.5)
    half = int(3 * sigma + 0.5)
    xs = np.arange(-half, half + 1)
    kern = np.exp(-0.5 * (xs / sigma) ** 2)
    k = torch.from_numpy((kern / kern.sum()).astype(np.float32)).to(mask.device)
    lead = mask.shape[:-3]
    m = mask[..., 0].reshape(-1, 1, *mask.shape[-3:-1]).float()
    m = F.conv2d(m, k.view(1, 1, -1, 1), padding=(half, 0))
    m = F.conv2d(m, k.view(1, 1, 1, -1), padding=(0, half))
    return m.reshape(*lead, *mask.shape[-3:-1], 1)


def apply_fill_mode(image: torch.Tensor, mask: torch.Tensor, fill_mode: int) -> torch.Tensor:
    """A1111 `inpainting_fill` pixel preprocessing of [H, W, 3] with mask
    [H, W, 1] (1 = regenerate): 0 "fill" puts the unmasked mean colour into
    the masked pixels; 1 "original" and the latent modes 2 and 3 leave the
    pixels as they are."""
    if fill_mode != 0:
        return image
    keep = 1.0 - mask
    denom = torch.clamp(keep.sum(), min=1.0)
    mean_color = (image * keep).sum(dim=(0, 1)) / denom
    return image * keep + mean_color * mask


def resize_linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] f32 weights of `jax.image.resize(..., "linear")` along one
    axis (antialiased: the triangle kernel widens by in/out when
    downsampling; each output's weights sum to 1)."""
    f32 = np.float32
    scale = f32(out_size) / f32(in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def resize_linear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[B, H, W, C] f32 -> [B, out_h, out_w, C], as `jax.image.resize(x,
    (B, out_h, out_w, C), "linear")`: two f32 matmuls."""
    _, h, w, _ = x.shape
    wy = torch.from_numpy(resize_linear_weights(h, out_h)).to(x.device)
    wx = torch.from_numpy(resize_linear_weights(w, out_w)).to(x.device)
    if out_h != h:
        x = torch.einsum("bhwc,ho->bowc", x, wy)
    if out_w != w:
        x = torch.einsum("bhwc,wo->bhoc", x, wx)
    return x
