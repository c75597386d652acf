"""Multi-resolution hash-grid encoding (instant-ngp), plain PyTorch.

Port of `signerf_tpu/ops/hashgrid.py`, the `encoding_backend="hash"`
encoding: nerfstudio's `HashEncoding` semantics. The JAX function is plain
`jnp` (no Pallas kernel), so this is the whole port: gathers with
`index_select` over the flattened [L T, F] table (its backward is an
`index_add_`, differentiable again for the gradient normals' second order)
and the trilinear weights in f32.

Semantics, as the JAX function has them:
  * positions are clamped to [0, 1] (max then min, so the derivative at a
    bound is split in half as `jnp.clip`'s is);
  * scaled = pos * res in f32, then floor and frac;
  * corners are clamped to [0, res] (a level has res + 1 grid points);
  * a level is dense when (res + 1)^3 <= T, else hashed, a static choice;
  * dense index x + y (res+1) + z (res+1)^2; hashed index
    (x * 1 ^ y * 2654435761 ^ z * 805459861) mod T in uint32 wraparound,
    computed in int64 (the products stay below 2^43) and masked to 32 bits;
  * the 8 corners in the x-fastest order of `_OFFSETS`, summed into one
    [L, N, F] accumulator: no [L, N, 8, F] tensor is ever built.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch

# instant-ngp hashing primes (pi1 = 1 for x)
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

# The 8 unit-cube corner offsets, ordered x-fastest.
_OFFSETS = tuple((i & 1, (i >> 1) & 1, (i >> 2) & 1) for i in range(8))


def hashgrid_resolutions(num_levels: int, base_res: int, max_res: int) -> Tuple[int, ...]:
    """Per-level grid resolutions N_l = floor(N_min * b^l)."""
    if num_levels == 1:
        return (base_res,)
    growth = math.exp((math.log(max_res) - math.log(base_res)) / (num_levels - 1))
    return tuple(int(math.floor(base_res * growth**lvl)) for lvl in range(num_levels))


def init_hashgrid_table(
    generator: torch.Generator,
    num_levels: int,
    table_size: int,
    features_per_level: int,
    dtype: torch.dtype = torch.float32,
    scale: float = 1e-4,
) -> torch.Tensor:
    """Uniform [-scale, scale] table [L, T, F] drawn from `generator` (on
    the generator's device), the instant-ngp convention."""
    shape = (num_levels, table_size, features_per_level)
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return u * (2.0 * scale) - scale


@functools.cache
def _level_constants(resolutions: Tuple[int, ...], table_size: int, dtype: torch.dtype, device: torch.device):
    """(res [L] in `dtype`, res [L, 1, 1] int64, strides res + 1 [L, 1],
    dense [L, 1], corner offsets [8, 3] int64, level starts [L, 1]) on
    `device`, made once: a call after the first copies nothing from the
    host, so a CUDA graph can capture the encode (`engine/chunk_graph.py`).
    Kept for the process's life: a captured graph reads them at their
    addresses (a handful of configurations make the keys).
    Made outside inference mode, since training saves them for backward."""
    with torch.inference_mode(False):
        as_int = torch.tensor(resolutions, dtype=torch.int64, device=device)
        return (
            as_int.to(dtype),
            as_int[:, None, None],
            (as_int + 1)[:, None],
            torch.tensor([(r + 1) ** 3 <= table_size for r in resolutions], device=device)[:, None],
            torch.tensor(_OFFSETS, dtype=torch.int64, device=device),
            (torch.arange(len(resolutions), device=device) * table_size)[:, None],
        )


def _corner_index(coords: torch.Tensor, resolutions: Sequence[int], table_size: int) -> torch.Tensor:
    """Table indices [L, N] (int64, within each level's table) of one corner
    per level, from its int64 coordinates [L, N, 3] already clamped to
    [0, res]."""
    _, _, strides, dense, _, _ = _level_constants(tuple(resolutions), table_size, torch.float32, coords.device)
    x, y, z = coords.unbind(-1)
    idx_dense = x + y * strides + z * strides * strides
    hashed = (x * _PRIMES[0]) ^ (y * _PRIMES[1]) ^ (z * _PRIMES[2])
    idx_hash = (hashed & _U32) % table_size
    return torch.where(dense, idx_dense, idx_hash)


def hashgrid_encode(
    table: torch.Tensor, positions: torch.Tensor, resolutions: Sequence[int]
) -> torch.Tensor:
    """table [L, T, F], positions [..., 3] in [0, 1]^3 (clamped) ->
    [..., L * F] per-level trilinear features, level-major."""
    num_levels, table_size, feat = table.shape
    if len(resolutions) != num_levels:
        raise ValueError(f"{len(resolutions)} resolutions for a table of {num_levels} levels")
    batch_shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3)
    pos = torch.minimum(torch.maximum(pos, pos.new_zeros(())), pos.new_ones(()))
    n = pos.shape[0]
    res, max_coord, _, _, offsets, level_start = _level_constants(tuple(resolutions), table_size, pos.dtype,
                                                                  pos.device)

    scaled = pos[None, :, :] * res[:, None, None]  # [L, N, 3]
    floor = torch.floor(scaled)
    frac = scaled - floor
    base = floor.to(torch.int64)
    flat = table.reshape(num_levels * table_size, feat)

    feats = None
    for off, offset in zip(_OFFSETS, offsets):
        corner = torch.minimum(base + offset, max_coord)
        idx = _corner_index(corner, resolutions, table_size) + level_start  # [L, N]
        wx, wy, wz = (frac[..., a] if o else 1.0 - frac[..., a] for a, o in enumerate(off))
        w = wx * wy * wz  # [L, N]
        gathered = flat.index_select(0, idx.reshape(-1)).reshape(num_levels, n, feat)
        term = w[..., None] * gathered
        feats = term if feats is None else feats + term
    out = feats.permute(1, 0, 2).reshape(n, num_levels * feat)
    return out.reshape(*batch_shape, num_levels * feat)
