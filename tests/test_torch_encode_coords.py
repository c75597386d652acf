"""K4's coords half is K5's function: du_a = sum_l sum_F g f_b f_c d_a (K4's
coords grad, given the encode's cotangent g) equals s_a = sum_l sum_F d_a
f_b f_c g (K5's contraction, with g in its place), under the same knot rule
(the slope is 0 where u (R - 1) is an integer). The CUDA port runs K4's
coords half on K5's tile loop on the strength of it; these tests pin the
identity on the CPU in both packages, at the base field's schedule and the
proposal schedule: the port's plain twins, and the JAX package's Pallas
kernels in interpret mode.

Inputs are made with numpy from a seed, with rows on u = 0 and u = 1 (knots
of every level) and rows with one axis on an exact knot of one level.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.ops import factor_grid as jfg
from signerf_tpu.ops import fused_factor_pallas as ffp
from signerf_tpu_torch.ops import factor_grid as tfg
from signerf_tpu_torch.ops import fused_factor_cuda as ffc

torch.set_num_threads(2)

SCHEDULES = {  # (levels, base_res, max_res, features_per_level), as the fields take them
    "base": (8, 16, 2048, 16),
    "proposal": (5, 16, 128, 8),
}
# u = 0 and u = 1 are knots of every level: rows 0 and 1 on every axis,
# rows 2 and 3 on two axes each (u = 0.5 is no knot of these schedules).
BOUNDARY = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]]
KNOT_AXES = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 1), (2, 2), (3, 0), (3, 1)]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def make_case(name, n=256, seed=0):
    levels, base, max_res, feat = SCHEDULES[name]
    jcfg = jfg.FactorGridConfig(num_levels=levels, base_res=base, max_res=max_res, features_per_level=feat)
    tcfg = tfg.FactorGridConfig(num_levels=levels, base_res=base, max_res=max_res, features_per_level=feat)
    assert jcfg.resolutions == tcfg.resolutions
    rng = np.random.default_rng(seed)
    lines = [[(rng.standard_normal((r, feat)) * 0.3).astype(np.float32) for _ in range(3)] for r in jcfg.resolutions]
    x = rng.random((n, 3)).astype(np.float32)
    x[: len(BOUNDARY)] = BOUNDARY
    # One row per level with its axis l % 3 on an exact knot of that level:
    # u (R - 1) rounds to an integer in f32, as the kernels' taps compute it.
    for lvl, r in enumerate(jcfg.resolutions):
        for k in rng.permutation(np.arange(1, r - 1)):
            u = np.float32(k / (r - 1))
            if np.float32(u * np.float32(r - 1)) == k:
                x[len(BOUNDARY) + lvl, lvl % 3] = u
                break
        else:
            raise AssertionError(f"no exact knot found at res {r}")
    g = rng.standard_normal((n, tcfg.out_dim)).astype(np.float32)
    return jcfg, tcfg, lines, x, g


def assert_zero_at_knots(out):
    for row, axis in KNOT_AXES:
        assert float(out[row, axis]) == 0.0, (row, axis, out[:4])
    assert np.all(np.asarray(out)[2:4][np.array(BOUNDARY)[2:4] == 0.5] != 0.0)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k4_coords_twin_is_k5_twin(name):
    """The port's plain twins: K4's coords half equals K5 on the same g, to
    the f32 rounding of their products taken in another order, and both
    are exactly 0 on an axis at a knot of every level."""
    _, tcfg, lines, x, g = make_case(name, n=1024, seed=11)
    args = (tcfg.resolutions, tcfg.features_per_level,
            tfg.pack_tables([[torch.from_numpy(a) for a in axes] for axes in lines]), torch.from_numpy(x))
    k4 = ffc.encode_bwd_plain(*args, torch.from_numpy(g), tables_half=False, coords_half=True)[1].numpy()
    k5 = ffc.grad_dot_plain(*args, torch.from_numpy(g)).numpy()
    assert k4.shape == k5.shape == (len(x), 3)
    assert rel(k4, k5) < 1e-6, rel(k4, k5)  # measured 8.9e-8 (base) and 8.2e-8 (proposal)
    rows = slice(len(BOUNDARY), len(BOUNDARY) + len(tcfg.resolutions))  # one axis on one level's knot
    assert rel(k4[rows], k5[rows]) < 1e-6
    assert_zero_at_knots(k4)
    assert_zero_at_knots(k5)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k4_coords_pallas_is_k5_pallas_in_interpret_mode(name, monkeypatch):
    """The JAX package's own kernels, run as its tests run them on the CPU
    (`FORCE_INTERPRET`, unjitted): the coords grad of the fused encode's
    Pallas backward equals the Pallas grad-dot on the same g, with the same
    exact zeros; the port's K4 coords twin agrees with them off the rows on
    one level's interior knot."""
    jcfg, tcfg, lines, x, g = make_case(name, seed=12)
    monkeypatch.setattr(ffp, "FORCE_INTERPRET", True)
    jl = tuple(tuple(jnp.asarray(a) for a in axes) for axes in lines)
    _, vjp = jax.vjp(lambda xx: jfg._encode_fused(jcfg, jl, xx), jnp.asarray(x))
    (k4,) = vjp(jnp.asarray(g))
    k4 = np.asarray(k4)
    k5 = np.asarray(jfg.grad_encode_dot(jcfg, jl, jnp.asarray(x), jnp.asarray(g)))
    assert k4.shape == k5.shape == (len(x), 3)
    # The same taps and slopes in the two kernels, their sums in another
    # order: measured 1.2e-7 (base) and 9.2e-8 (proposal).
    assert rel(k4, k5) < 1e-6, rel(k4, k5)
    assert_zero_at_knots(k4)
    assert_zero_at_knots(k5)
    twin = ffc.encode_bwd_plain(
        tcfg.resolutions, tcfg.features_per_level,
        tfg.pack_tables([[torch.from_numpy(a) for a in axes] for axes in lines]), torch.from_numpy(x),
        torch.from_numpy(g), tables_half=False, coords_half=True)[1].numpy()
    # f32 tap weights in the twin, bf16 hat weights on the Pallas kernels'
    # small levels: measured 9.1e-5 (base) and 6.8e-4 (proposal). The rows
    # on one level's interior knot are left out: there the Pallas taps may
    # land a rounding off the knot and take that level's slope, which the
    # twin takes as 0 (a difference on a set of measure zero).
    off = np.ones(len(x), bool)
    off[len(BOUNDARY) : len(BOUNDARY) + len(tcfg.resolutions)] = False
    assert rel(twin[off], k4[off]) < 0.01, rel(twin[off], k4[off])
