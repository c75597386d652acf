"""SDXL + ControlNet-depth img2img inpainting in PyTorch (the port of
`signerf_tpu/diffusion/sdxl_pipeline.py`).

CLIP encode -> VAE encode -> Euler-a over UNet + ControlNet with CFG and the
latent mask blend -> VAE decode, on the card unless the caller passes
`device="cpu"`. Every UNet and ControlNet self-attention runs through K7
(`ops/flash_attention.py`) on the card.

The scheduling gates are the JAX package's, with the same einsum-memory
model (`unet.FLASH_SCORE_BYTES_THRESHOLD`): the serial-views gate runs a
batch of views one at a time (and so decides which noise each view gets),
the sequential-CFG gate runs the uncond and cond branches one after the
other at sheet scale.

Tensor parallelism: `create(mesh=...)` with a mesh whose tensor size T is
above 1 builds this rank's shards of the UNet and the ControlNet
(`unet.TensorShard`; JAX's `_shard_params` over the "tensor" axis) and
everything else whole. Every rank of a tensor group then calls `img2img`
with the same inputs and seed, and all of them return the same images;
each self-attention runs K7 on the rank's own heads. Weights are read or
drawn whole and cut to the rank's shards, so every T holds the same
weights.

Weights: `create` builds the full architecture on the meta device and
materialises it in bf16 directly on the target device. It loads
`<weights_path>/sdxl_params.pt` (`{component: state_dict}` in the port's
names, e.g. written by `convert.sdxl_from_jax` or
`weight_conversion.convert_all` and `torch.save`) if it is there, else the
JAX package's `<weights_path>/sdxl_params.msgpack` (read through a memory
map and cast leaf by leaf, so the host holds no converted copy);
otherwise it fills the modules with flax's distributions (random weights:
the edited pixels are noise), and warns.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import numpy as np
import torch

from signerf_tpu_torch.convert import load_sdxl_from_jax_, shard_sdxl_state
from signerf_tpu_torch.diffusion import sampler as S
from signerf_tpu_torch.diffusion import unet as unet_mod
from signerf_tpu_torch.diffusion.clip import CLIP_BIGG_CONFIG, CLIP_L_CONFIG, CLIPTextConfig, CLIPTextModel
from signerf_tpu_torch.diffusion.layers import Conv, Dense, init_flax_
from signerf_tpu_torch.diffusion.tokenizer import load_tokenizer
from signerf_tpu_torch.diffusion.unet import (
    SDXL_UNET_CONFIG,
    TINY_UNET_CONFIG,
    WHOLE,
    ControlNet,
    TensorShard,
    UNet2DConditionModel,
    UNetConfig,
)
from signerf_tpu_torch.diffusion.vae import TINY_VAE_CONFIG, AutoencoderKL, VAEConfig
from signerf_tpu_torch.engine.checkpoints import msgpack_restore_file

if TYPE_CHECKING:
    from signerf_tpu_torch.parallel.mesh import DataMesh

COMPONENTS = ("unet", "controlnet", "vae", "clip_l", "clip_g")


@dataclasses.dataclass(frozen=True)
class SDXLConfig:
    unet: UNetConfig = SDXL_UNET_CONFIG
    vae: VAEConfig = VAEConfig()
    clip_l: CLIPTextConfig = CLIP_L_CONFIG
    clip_g: CLIPTextConfig = CLIP_BIGG_CONFIG
    vae_downscale: int = 8  # 2^(len(vae.block_out_channels)-1)


TINY_SDXL_CONFIG = SDXLConfig(
    unet=TINY_UNET_CONFIG,
    vae=TINY_VAE_CONFIG,
    clip_l=CLIPTextConfig(vocab_size=49408, hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2),
    clip_g=CLIPTextConfig(vocab_size=49408, hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2,
                          projection_dim=16),
    vae_downscale=2,
)


def _worst_selfattn_scores(ucfg: UNetConfig, lat_h: int, lat_w: int) -> int:
    """Largest per-batch-element self-attention score term (heads * S^2):
    block i attends at latent >> i with ch / head_dim heads."""
    return max(
        (
            (ch // ucfg.attention_head_dim) * ((lat_h >> i) * (lat_w >> i)) ** 2
            for i, ch in enumerate(ucfg.block_out_channels)
            if ucfg.transformer_layers[i] > 0
        ),
        default=0,
    )


@dataclasses.dataclass
class SheetEncodeCache:
    """Cross-view VAE work cache for per-view sheet regeneration: the
    conv-only encoder features of the base sheet, reused while only the
    sheet's last cell changes (see the JAX package's docstring for the
    windowing argument). Build with `SDXLInpaintPipeline.prepare_sheet_cache`."""

    down_feats: torch.Tensor  # [1, Hl, Wl, C] conv-only encoder features (device)
    sheet_hw: Tuple[int, int]  # (H, W) pixels
    cell_hw: Tuple[int, int]  # last-cell (h, w) pixels
    window_lat: Tuple[int, int, int, int, int, int]
    # (enc_wh, enc_ww, splice_h, splice_w, dec_wh, dec_ww) in latent units


# Latent-unit margins for the windowed sheet fast path (the SDXL VAE's conv
# receptive half-width is ~8.5 latent px on the encoder down path and ~12.5
# on the decoder up path; 16 covers both).
LASTCELL_ENC_CTX_PAD_LAT = 16
LASTCELL_ENC_SPLICE_PAD_LAT = 16
LASTCELL_DEC_PAD_LAT = 16

CONTROL_MODES = {
    "balanced": "balanced",
    "my prompt is more important": "prompt",
    "controlnet is more important": "controlnet",
}


def _f32(x, device) -> torch.Tensor:
    """A numpy array or a tensor -> an f32 tensor on `device`."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x, np.float32), dtype=torch.float32,
                           device=device)


def tensor_shard(mesh: Optional["DataMesh"]) -> TensorShard:
    """This rank's shard of a mesh's tensor group (whole without one)."""
    if mesh is None or mesh.tensor == 1:
        return WHOLE
    return TensorShard(mesh.tensor_rank, mesh.tensor, mesh.tensor_all_sum_)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no silent CPU path."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the diffusion port on the CPU")
    return device


class SDXLInpaintPipeline:
    """Holds the five modules and exposes `img2img`."""

    def __init__(self, config: SDXLConfig, modules: Dict[str, torch.nn.Module], tokenizer, device,
                 tp: TensorShard = WHOLE):
        assert config.clip_l.hidden_size + config.clip_g.hidden_size == config.unet.cross_attention_dim, (
            "UNet cross_attention_dim must equal concat CLIP hidden sizes"
        )
        self.config = config
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.tp = tp
        for mod in modules.values():
            mod.eval().requires_grad_(False)  # inference only
        self.unet = modules["unet"]
        self.controlnet = modules["controlnet"]
        self.vae = modules["vae"]
        self.clip_l = modules["clip_l"]
        self.clip_g = modules["clip_g"]
        self._prompt_cache: Dict[Tuple[str, str], Any] = {}
        # What the last img2img ran, for callers that report it.
        self.last_run: Dict[str, Any] = {}

    @staticmethod
    def build_modules(config: SDXLConfig, tp: TensorShard = WHOLE) -> Dict[str, torch.nn.Module]:
        """The five modules with uninitialised bf16 parameters (on the
        current default device: build under `torch.device("meta")` to
        allocate nothing), the UNet and the ControlNet as `tp`'s shards."""
        pooled = config.clip_g.projection_dim or config.clip_g.hidden_size
        return {
            "unet": UNet2DConditionModel(config.unet, pooled_dim=pooled, tp=tp),
            # 3-channel (RGB depth) conditioning, as diffusers' conv_in [16, 3, 3, 3]
            "controlnet": ControlNet(config.unet, cond_downscale_steps=int(np.log2(config.vae_downscale)),
                                     pooled_dim=pooled, tp=tp),
            "vae": AutoencoderKL(config.vae),
            "clip_l": CLIPTextModel(config.clip_l),
            "clip_g": CLIPTextModel(config.clip_g),
        }

    @classmethod
    def create(
        cls,
        weights_path: Optional[str | Path] = None,
        config: Optional[SDXLConfig] = None,
        seed: int = 0,
        device=None,
        mesh: Optional["DataMesh"] = None,
    ) -> "SDXLInpaintPipeline":
        """The full SDXL architecture unless `config` says otherwise (the
        tiny config is for tests), on the card unless `device` says
        otherwise (with a `mesh`, its rank's device), in bf16. Weights come
        from `weights_path`'s `sdxl_params.pt` (the port's `{component:
        state_dict}`), else its `sdxl_params.msgpack` (the JAX package's
        params tree, flax msgpack, as `scripts/convert_sdxl_weights.py`
        writes it), else a seeded random init with a RANDOM-INIT warning.
        With a `mesh` of tensor size T > 1 the UNet and the ControlNet hold
        this rank's shards of those weights. Sets `init_seconds` on the
        result."""
        t0 = time.perf_counter()
        config = config or SDXLConfig()
        device = resolve_device(mesh.device if device is None and mesh is not None else device)
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False  # the f32 mask blur stays f32
        tokenizer = load_tokenizer(weights_path)
        tp = tensor_shard(mesh)
        head_dim = config.unet.attention_head_dim
        with torch.device("meta"):
            modules = cls.build_modules(config, tp)
        modules = {k: m.to_empty(device=device) for k, m in modules.items()}
        root = Path(weights_path) if weights_path is not None else None
        if root is not None and (root / "sdxl_params.pt").exists():
            state = torch.load(root / "sdxl_params.pt", map_location=device, weights_only=True)
            state = shard_sdxl_state(state, tp.rank, tp.size, head_dim)
            for name, mod in modules.items():
                mod.load_state_dict(state[name], strict=True)
            del state
        elif root is not None and (root / "sdxl_params.msgpack").exists():
            # the JAX package's weights (scripts/convert_sdxl_weights.py,
            # f32): decoded as views of the mapped file, cast leaf by leaf
            load_sdxl_from_jax_(modules, msgpack_restore_file(root / "sdxl_params.msgpack"), tp.rank, tp.size,
                                head_dim)
        else:
            from signerf_tpu_torch.utils.calibration import warn_uncalibrated

            warn_uncalibrated(
                "SDXL",
                f"(weights_path={weights_path!r} holds neither sdxl_params.pt nor sdxl_params.msgpack) "
                "edited images will be noise, not edits. Convert real checkpoints with "
                "signerf_tpu_torch.diffusion.weight_conversion into sdxl_params.pt, or with the JAX "
                "package's scripts/convert_sdxl_weights.py into sdxl_params.msgpack, and pass weights_path.",
            )
            gen = torch.Generator(device=device).manual_seed(seed)
            for name in COMPONENTS:
                init_flax_(modules[name], gen)
        pipe = cls(config, modules, tokenizer, device, tp)
        pipe.to_channels_last()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        pipe.init_seconds = time.perf_counter() - t0
        return pipe

    def tensors(self, sharded: Optional[bool] = None):
        """Every parameter and buffer of the five modules (for the ranks'
        weight check, `DataMesh.assert_replicas_equal`); with `sharded`
        True only this rank's shards of the tensor-parallel leaves, with
        False only the leaves that every rank holds whole."""
        for name in COMPONENTS:
            for mod in getattr(self, name).modules():
                split = isinstance(mod, Dense) and mod.shard is not None
                for leaf, t in itertools.chain(mod.named_parameters(recurse=False), mod.named_buffers(recurse=False)):
                    # a row-parallel Dense's bias is whole on every rank
                    is_shard = split and (leaf == "kernel" or mod.shard.dim == 1)
                    if sharded is None or sharded == is_shard:
                        yield t

    def load_state_dicts(self, state: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load a whole `{component: state_dict}` (e.g.
        `convert.sdxl_from_jax`), cut to this rank's shards."""
        state = shard_sdxl_state(state, self.tp.rank, self.tp.size, self.config.unet.attention_head_dim)
        for name in COMPONENTS:
            getattr(self, name).load_state_dict(state[name], strict=True)
        self.to_channels_last()
        self._prompt_cache.clear()

    def to_channels_last(self) -> None:
        """On the card, hold the conv kernels channels_last, the layout of
        the NHWC activations, so cuDNN needs no transposes."""
        if self.device.type != "cuda":
            return
        for name in COMPONENTS:
            for mod in getattr(self, name).modules():
                if isinstance(mod, Conv):
                    mod.kernel.data = mod.kernel.data.contiguous(memory_format=torch.channels_last)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode_prompt(self, prompt: str, negative_prompt: str = ""):
        """-> (context [2, 77, D] f32, pooled [2, P] f32) for (uncond, cond),
        cached per (prompt, negative)."""
        cached = self._prompt_cache.get((prompt, negative_prompt))
        if cached is not None:
            return cached
        ids = np.stack([self.tokenizer(negative_prompt), self.tokenizer(prompt)])
        ids = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        _, pen_l, _ = self.clip_l(ids)
        _, pen_g, _, proj_g = self.clip_g(ids)
        out = (torch.cat([pen_l.float(), pen_g.float()], dim=-1), proj_g.float())
        if len(self._prompt_cache) > 32:
            self._prompt_cache.clear()
        self._prompt_cache[(prompt, negative_prompt)] = out
        return out

    @torch.no_grad()
    def prepare_sheet_cache(self, image, cell_hw: Tuple[int, int]) -> SheetEncodeCache:
        """Encode-down the base sheet once for the per-view loop. `image`:
        [H, W, 3] float in [0, 1] (numpy or a tensor); `cell_hw`: the last
        cell's (height, width)."""
        f = self.config.vae_downscale
        img = _f32(image, self.device)[None]
        _, h, w = img.shape[:3]
        assert h % f == 0 and w % f == 0, (h, w, f)
        hl, wl = h // f, w // f
        feats = self.vae.encode_down(img * 2.0 - 1.0)

        def dims(cell_px, full_lat):
            cell_lat = -((-cell_px) // f)  # ceil
            splice = min(cell_lat + LASTCELL_ENC_SPLICE_PAD_LAT, full_lat)
            enc_w = min(splice + LASTCELL_ENC_CTX_PAD_LAT, full_lat)
            dec_w = min(cell_lat + LASTCELL_DEC_PAD_LAT, full_lat)
            return enc_w, splice, dec_w

        eh, sh_, dh = dims(cell_hw[0], hl)
        ew, sw_, dw = dims(cell_hw[1], wl)
        return SheetEncodeCache(feats, (h, w), tuple(cell_hw), (eh, ew, sh_, sw_, dh, dw))

    # ------------------------------------------------------------------

    @torch.no_grad()
    def img2img(
        self,
        image,  # [H, W, 3] or [K, H, W, 3] float in [0, 1]
        prompt: str,
        negative_prompt: str = "",
        mask=None,  # [(K,) H, W, 1] float, 1 = edit
        control_image=None,  # [(K,) H, W, 1|3] depth
        strength: float = 0.9,
        num_steps: int = 20,
        guidance_scale: float = 7.0,
        controlnet_scale: float = 0.8,
        controlnet_start: float = 0.0,
        controlnet_end: float = 1.0,
        seed: int = 1,
        mask_blur: int = 4,
        inpainting_fill: int = 1,
        control_mode: str = "balanced",
        device_out: bool = False,
        sheet_cache: Optional[SheetEncodeCache] = None,
        noise_source: Optional[S.NoiseSource] = None,
    ):
        """Edit one image or a batch of views. Returns float32 numpy (or a
        tensor on the pipeline's device with `device_out=True`) of the
        input's shape; with a matching `sheet_cache` (one image and a mask)
        the decoded bottom-right window [dec_wh*f, dec_ww*f, 3] instead.

        `noise_source` replaces the seeded generator (tests feed JAX's
        draws through it); by default every call draws from a fresh
        `torch.Generator` seeded with `seed`, so each view of a serial batch
        gets the same draws, as in JAX."""
        cfg = self.config
        dev = self.device
        single = np.ndim(image) == 3
        img = _f32(image, dev)
        if single:
            img = img[None]
        k_batch, h, w = img.shape[:3]
        f = cfg.vae_downscale
        assert h % f == 0 and w % f == 0, f"image dims must be /{f} (sheet is /8-padded upstream)"

        # Serial views: the batch fits the einsum-memory model at K = 1 but
        # not at K; run the views one at a time (each with its own seed draw).
        if not single and k_batch > 1:
            worst = _worst_selfattn_scores(cfg.unet, h // f, w // f)
            limit = unet_mod.FLASH_SCORE_BYTES_THRESHOLD
            if cfg.unet.use_flash_attention and 2 * worst < limit and 2 * k_batch * worst >= limit:
                def per_view(x, k):
                    return x if x is None or np.ndim(x) == 3 else x[k]

                outs = [
                    self.img2img(img[k], prompt, negative_prompt, per_view(mask, k), per_view(control_image, k),
                                 strength, num_steps, guidance_scale, controlnet_scale, controlnet_start,
                                 controlnet_end, seed, mask_blur, inpainting_fill, control_mode,
                                 device_out=True, sheet_cache=sheet_cache, noise_source=noise_source)
                    for k in range(k_batch)
                ]
                self.last_run = dict(self.last_run, serial_views=True)
                out = torch.stack(outs)
                return out if device_out else out.cpu().numpy()

        def batched(x, channels):
            if x is None:
                return None
            arr = _f32(x, dev)
            if arr.dim() == 3:
                arr = arr[None].expand(k_batch, h, w, channels)
            return arr

        sigmas = S.strength_sigmas(S.get_sigmas(num_steps), strength)
        context, pooled = self.encode_prompt(prompt, negative_prompt)
        add_time_ids = torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32, device=dev)
        msk = batched(mask, 1)
        ctrl = batched(control_image, 3)
        if ctrl is None:
            ctrl = torch.zeros((k_batch, h, w, 3), dtype=torch.float32, device=dev)
        elif ctrl.shape[-1] == 1:
            ctrl = ctrl.repeat_interleave(3, dim=-1)

        mode = CONTROL_MODES.get(control_mode.strip().lower(), control_mode.strip().lower())
        if mode not in ("balanced", "prompt", "controlnet"):
            raise ValueError(f"unknown control_mode {control_mode!r}")

        window_lat = down_feats = None
        if sheet_cache is not None and k_batch == 1 and msk is not None and (h, w) == tuple(sheet_cache.sheet_hw):
            window_lat = tuple(sheet_cache.window_lat)
            down_feats = sheet_cache.down_feats
        if noise_source is None:
            noise_source = S.generator_noise(torch.Generator(device=dev).manual_seed(seed), dev)
        out = self._run(
            img, msk if msk is not None else torch.ones((k_batch, h, w, 1), device=dev), msk is not None, ctrl,
            context, pooled, add_time_ids, sigmas, guidance_scale, controlnet_scale, controlnet_start,
            controlnet_end, noise_source, mask_blur, inpainting_fill, mode, down_feats, window_lat,
        )
        # With random weights the ancestral chain can diverge; the JAX package
        # sanitises here too, without touching the sampler.
        out = torch.clamp(torch.nan_to_num(out, nan=0.5, posinf=1.0, neginf=0.0), 0.0, 1.0).float()
        out = out[0] if single else out
        return out if device_out else out.cpu().numpy()

    # ------------------------------------------------------------------

    def _run(self, image, mask, use_mask: bool, control_image, context, pooled, add_time_ids, sigmas,
             guidance_scale, controlnet_scale, controlnet_start, controlnet_end, noise: S.NoiseSource,
             mask_blur: int, inpainting_fill: int, control_mode: str = "balanced", down_cache=None,
             window_lat=None):
        cfg = self.config
        f = cfg.vae_downscale
        k_batch, h, w = image.shape[:3]
        vae = self.vae

        blurred = S.gaussian_blur(mask, mask_blur)
        filled = torch.stack([S.apply_fill_mode(image[k], blurred[k], inpainting_fill) for k in range(k_batch)])
        if window_lat is not None:
            # Windowed last-cell encode: the conv-only down path on the
            # bottom-right window, spliced into the cached sheet features,
            # then the global mid attention over the whole map.
            eh, ew, sp_h, sp_w, _, _ = window_lat
            win = filled[:, h - eh * f :, w - ew * f :, :]
            wfeats = vae.encode_down(win * 2.0 - 1.0)
            feats = down_cache.clone()
            feats[:, -sp_h:, -sp_w:, :] = wfeats[:, -sp_h:, -sp_w:, :].to(down_cache.dtype)
            init_latent = vae.encode_from_features(feats)
        else:
            # One image at a time: the full-resolution activations dominate memory.
            init_latent = torch.cat([vae.encode(filled[k : k + 1] * 2.0 - 1.0) for k in range(k_batch)])

        latent_mask = S.resize_linear(blurred.float(), h // f, w // f)
        if inpainting_fill == 2:  # masked latents replaced by noise
            fill = noise("fill", 0, tuple(init_latent.shape), torch.float32).to(init_latent.device)
            init_latent = init_latent.float() * (1 - latent_mask) + fill * latent_mask
        elif inpainting_fill == 3:  # masked latents zeroed
            init_latent = init_latent.float() * (1 - latent_mask)

        # Sequential CFG at sheet scale (the einsum-memory model), batched below.
        worst = _worst_selfattn_scores(cfg.unet, h // f, w // f)
        sequential_cfg = 2 * (2 * k_batch) * worst >= unet_mod.FLASH_SCORE_BYTES_THRESHOLD

        ctx_u, ctx_c = context[:1].repeat(k_batch, 1, 1), context[1:].repeat(k_batch, 1, 1)
        pooled_u, pooled_c = pooled[:1].repeat(k_batch, 1), pooled[1:].repeat(k_batch, 1)
        tids_k = add_time_ids.repeat(k_batch, 1)
        f32 = dict(dtype=torch.float32, device=image.device)
        cn_scale = torch.tensor(controlnet_scale, **f32)
        train_sigmas = S.make_sd_schedule()

        # control_mode (Mikubill ControlNet-extension semantics): balanced
        # applies the residuals to both branches; prompt scales shallow
        # residuals by 0.825^(n-i); controlnet runs the uncond branch uncontrolled.
        def eps_branch(x_in, t_cont, step_frac, ctx_b, pooled_b, tids_b, cb, cn_gain):
            tb = torch.full((x_in.shape[0],), float(t_cont), **f32)
            down_res, mid_res = self.controlnet(x_in, cb, tb, ctx_b, pooled_b, tids_b)
            active = float(controlnet_start <= step_frac <= controlnet_end)
            scale = cn_scale * active * cn_gain
            n_down = len(down_res)
            soft = [0.825 ** (n_down - i) for i in range(n_down)] if control_mode == "prompt" else [1.0] * n_down
            return self.unet(x_in, tb, ctx_b, pooled_b, tids_b,
                             extra_down_residuals=[r.float() * (scale * s) for r, s in zip(down_res, soft)],
                             extra_mid_residual=mid_res.float() * scale)

        def denoised_fn(x, sigma, step_frac):
            x_in = S.scale_model_input(x, sigma)
            t_cont = S.sigma_to_t(sigma, train_sigmas)
            uncond_gain = 0.0 if control_mode == "controlnet" else 1.0
            if sequential_cfg:
                eps_u = eps_branch(x_in, t_cont, step_frac, ctx_u, pooled_u, tids_k, control_image,
                                   torch.tensor(uncond_gain, **f32))
                eps_c = eps_branch(x_in, t_cont, step_frac, ctx_c, pooled_c, tids_k, control_image,
                                   torch.tensor(1.0, **f32))
            else:
                gains = torch.cat([torch.full((k_batch,), uncond_gain, **f32), torch.ones(k_batch, **f32)])
                eps = eps_branch(torch.cat([x_in, x_in]), t_cont, step_frac, torch.cat([ctx_u, ctx_c]),
                                 torch.cat([pooled_u, pooled_c]), torch.cat([tids_k, tids_k]),
                                 torch.cat([control_image, control_image]), gains[:, None, None, None])
                eps_u, eps_c = eps[:k_batch], eps[k_batch:]
            return S.eps_to_denoised(x, S.cfg_mix(eps_u, eps_c, torch.tensor(guidance_scale, **f32)), sigma)

        inpaint = S.InpaintSpec(init_latent, latent_mask if use_mask else torch.ones_like(latent_mask))
        step_events = []
        if image.device.type == "cuda":
            def mark(_i):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                step_events.append(ev)

            mark(-1)
        else:
            mark = None
        final = S.sample_euler_ancestral(noise, denoised_fn, init_latent, sigmas, inpaint, mark)
        self.last_run = {"sequential_cfg": sequential_cfg, "serial_views": False, "sampler_steps": len(sigmas) - 1,
                         "k_batch": k_batch, "windowed": window_lat is not None, "step_events": step_events}
        if window_lat is not None:
            # Global attention over the whole latent, image-resolution convs
            # over the consumed window only.
            dec_h, dec_w = window_lat[4], window_lat[5]
            dfeats = vae.decode_mid(final)
            decoded = vae.decode_up(dfeats[:, -dec_h:, -dec_w:, :])
        else:
            decoded = torch.cat([vae.decode(final[k : k + 1]) for k in range(k_batch)])
        return (decoded + 1.0) / 2.0
