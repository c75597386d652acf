"""SDXL base + ControlNet-depth img2img inpainting in PyTorch (the port of
`signerf_tpu/diffusion/`): CLIP text towers, UNet, ControlNet, VAE, the
Euler-ancestral sampler, the inpaint pipeline and the `Diffuser` front end.
Every UNet and ControlNet self-attention runs through K7
(`ops/flash_attention.py`) on the card."""
