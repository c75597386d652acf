"""Shared set-up of the diffusion port's parity tests (tests/test_torch_diffusion_*.py).

- `tiny_pipelines(seed)`: the JAX package's `TINY_SDXL_CONFIG` pipeline with
  seeded numpy params (non-zero biases, norm scales near 1 and non-zero
  ControlNet zero convs, so that every path carries signal) and the port's
  pipeline on the CPU with the same params, carried across by
  `convert.sdxl_from_jax`.
- `JaxDraws(seed)`: a noise source for the port that returns the draws the
  JAX pipeline makes from `PRNGKey(seed)` (`_run`'s split into k_enc,
  k_fill, k_sample; the sampler's k_init, k_loop and per step (k, sub) and
  (k, sub2)), so that both sample with the same noise.
- `rel`: the norm-relative error of a against b.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from signerf_tpu.diffusion import sdxl_pipeline as jax_pipe
from signerf_tpu.diffusion.tokenizer import HashTokenizer
from signerf_tpu_torch.convert import sdxl_from_jax
from signerf_tpu_torch.diffusion import sdxl_pipeline as torch_pipe


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def to_np(x) -> np.ndarray:
    """A JAX array (any dtype) or a torch tensor -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().copy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def seeded_params(shapes, seed: int):
    """numpy params for a tree of shape structs: kernels N(0, 1/fan_in),
    biases N(0, 0.05), norm scales 1 + N(0, 0.1), embeddings N(0, 1/feat),
    position embeddings N(0, 0.01); rounded to bf16 as the pipeline holds them."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = tuple(s.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "bias":
            v = rng.standard_normal(shape) * 0.05
        elif name == "scale":
            v = 1.0 + rng.standard_normal(shape) * 0.1
        elif name == "embedding":
            v = rng.standard_normal(shape) / np.sqrt(shape[-1])
        else:  # position_embedding
            v = rng.standard_normal(shape) * 0.01
        return np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tiny_pipelines(seed: int = 0):
    """(JAX pipeline, port pipeline on the CPU, numpy params) at TINY_SDXL_CONFIG."""
    shapes = jax.eval_shape(lambda: jax_pipe.SDXLInpaintPipeline._random_init(jax_pipe.TINY_SDXL_CONFIG, 0))
    params = seeded_params(shapes, seed)
    jp = jax_pipe.SDXLInpaintPipeline(
        jax_pipe.TINY_SDXL_CONFIG, jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params),
        HashTokenizer())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tp = torch_pipe.SDXLInpaintPipeline.create(config=torch_pipe.TINY_SDXL_CONFIG, device="cpu")
    tp.load_state_dicts(sdxl_from_jax(params))
    return jp, tp, params


class JaxDraws:
    """The JAX pipeline's normal draws for seed `seed`, by name and step."""

    def __init__(self, seed: int):
        _, self.k_fill, k_sample = jax.random.split(jax.random.PRNGKey(seed), 3)
        self.k_init, self.k = jax.random.split(k_sample)
        self.steps = []
        self.calls = []

    def __call__(self, name, step, shape, dtype):
        self.calls.append((name, step))
        if name == "fill":
            key = self.k_fill
        elif name == "init":
            key = self.k_init
        else:
            while len(self.steps) <= step:
                self.k, sub = jax.random.split(self.k)
                self.k, sub2 = jax.random.split(self.k)
                self.steps.append((sub, sub2))
            key = self.steps[step][0 if name == "step" else 1]
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        return torch.from_numpy(to_np(jax.random.normal(key, tuple(shape), jdt))).to(dtype)
