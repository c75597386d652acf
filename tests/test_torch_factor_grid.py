"""The port's encode + density-MLP module (K1's plain twin and dispatch)
against the JAX package's two versions: the XLA reference expression and
the Pallas TPU kernel run in interpret mode.

Inputs are made with numpy from a seed and handed to both frameworks.
"""

import functools

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

# The three production schedules (tests/test_fused_factor.py CONFIGS) with
# their MLP widths: (levels, max_res, F, hidden, out).
SCHEDULES = {
    "proposal": (5, 128, 8, 16, 1),
    "prop256": (5, 256, 8, 16, 1),
    "final": (8, 2048, 16, 64, 16),
}
BOUNDARY = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]]


def make_case(name, n=257, seed=0):
    levels, max_res, feat, hidden, out = SCHEDULES[name]
    rng = np.random.default_rng(seed)
    jcfg = jfg.FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat)
    tcfg = tfg.FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat)
    assert jcfg.resolutions == tcfg.resolutions
    lines = [
        [(rng.standard_normal((r, feat)) * 0.2).astype(np.float32) for _ in range(3)]
        for r in jcfg.resolutions
    ]
    d = levels * feat
    ws = (
        ((rng.standard_normal((d, hidden)) * 0.1).astype(np.float32),
         (rng.standard_normal(hidden) * 0.05).astype(np.float32)),
        ((rng.standard_normal((hidden, out)) * 0.1).astype(np.float32),
         (rng.standard_normal(out) * 0.05).astype(np.float32)),
    )
    x = rng.random((n, 3)).astype(np.float32)
    x[: len(BOUNDARY)] = BOUNDARY  # u = 0 and u = 1 exactly
    return jcfg, tcfg, lines, ws, x


def to_jax(lines, ws, x):
    jl = tuple(tuple(jnp.asarray(a) for a in axes) for axes in lines)
    jw = tuple((jnp.asarray(k), jnp.asarray(b)) for k, b in ws)
    return jl, jw, jnp.asarray(x)


def jax_call(fn, cfg, *args):
    """One jitted program instead of op-by-op dispatch: same ops, faster."""
    return jax.jit(functools.partial(fn, cfg))(*args)


def to_torch(lines, ws, x):
    tl = [[torch.from_numpy(a) for a in axes] for axes in lines]
    tw = tuple((torch.from_numpy(k), torch.from_numpy(b)) for k, b in ws)
    return tl, tw, torch.from_numpy(x)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_plain_kernel_twin_matches_xla_reference(name):
    jcfg, tcfg, lines, ws, x = make_case(name)
    ref = np.asarray(jax_call(jfg.density_mlp_reference, jcfg, *to_jax(lines, ws, x)))
    got = tfg.fused_density_mlp(tcfg, *to_torch(lines, ws, x)).numpy()
    assert got.shape == ref.shape == (x.shape[0], SCHEDULES[name][4])
    # The kernel's contract keeps f32 tap weights and f32 axis products; the
    # reference rounds both to bf16. The bf16 rounding then differs at the
    # MLP input, so outputs agree to bf16 noise of the output range: the
    # same 0.02 * max|ref| that tests/test_fused_factor.py allows the TPU
    # kernel against this reference (measured here: under 0.008).
    tol = 0.02 * max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, atol=tol)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_plain_kernel_twin_matches_pallas_interpret(name, monkeypatch):
    jcfg, tcfg, lines, ws, x = make_case(name, seed=1)
    # Run the TPU kernel the way tests/test_fused_factor.py does on the CPU,
    # unjitted: XLA:CPU cannot run interpret mode's bf16 x bf16 -> f32 dots
    # once an outer jit compiles them.
    monkeypatch.setattr(ffp, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jfg, "use_fused_kernel", lambda: True)
    ref = np.asarray(jfg.fused_density_mlp(jcfg, *to_jax(lines, ws, x)))
    got = tfg.fused_density_mlp(tcfg, *to_torch(lines, ws, x)).numpy()
    assert got.shape == ref.shape
    # Interpret mode feeds layer 0 f32 features (ffp head_dtype) and keeps
    # bf16 tap weights on levels of res <= 64; the port rounds features to
    # bf16 and keeps f32 weights everywhere. Same bf16-noise bound as above.
    tol = 0.02 * max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, atol=tol)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_reference_expression_matches_jax(name):
    """The port of the XLA expression itself: same contract, same roundings."""
    jcfg, tcfg, lines, ws, x = make_case(name, seed=2)
    ref = np.asarray(jax_call(jfg.density_mlp_reference, jcfg, *to_jax(lines, ws, x)))
    got = tfg.density_mlp_reference(tcfg, *to_torch(lines, ws, x)).numpy()
    # Identical roundings; only f32 summation order differs, which can flip
    # a bf16 rounding by one ulp (2^-8 relative) at the output.
    tol = 2**-7 * max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, atol=tol)


def test_hat_matrix_matches_jax():
    u = np.random.default_rng(3).random(100).astype(np.float32)
    u[:2] = [0.0, 1.0]
    for dtype, jdtype in [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]:
        ref = np.asarray(jfg.hat_matrix(jnp.asarray(u), 37, jdtype).astype(jnp.float32))
        got = tfg.hat_matrix(torch.from_numpy(u), 37, dtype).float().numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)  # f32 ops in the same order


def test_encode_reference_matches_jax():
    jcfg, tcfg, lines, ws, x = make_case("final", n=64, seed=4)
    jl, _, jx = to_jax(lines, ws, x)
    tl, _, tx = to_torch(lines, ws, x)
    ref = np.asarray(jax_call(jfg._encode_reference, jcfg, jl, jx))
    got = tfg._encode_reference(tcfg, tl, tx).numpy()
    # bf16 features: one-ulp flips from the f32 summation order, 2^-8 relative.
    np.testing.assert_allclose(got, ref, atol=2**-8 * float(np.abs(ref).max()))


def test_cpu_dispatch_is_the_plain_twin():
    _, tcfg, lines, ws, x = make_case("proposal", seed=5)
    tl, tw, tx = to_torch(lines, ws, x)
    (k0, b0), (k1, b1) = tw
    bf = torch.bfloat16
    twin = ffc.density_mlp_plain(
        tcfg.resolutions, tcfg.features_per_level, tfg.pack_tables(tl),
        k0.to(bf), b0.to(bf), k1.to(bf), b1.to(bf), tx,
    )
    before = ffc.launches
    got = tfg.fused_density_mlp(tcfg, tl, tw, tx)
    assert torch.equal(got, twin)
    assert ffc.launches == before  # a CPU tensor launches nothing


def test_plain_twin_is_the_stated_gather():
    """One sample by hand: two-tap lerp per axis in f32, f32 product,
    then the bf16 MLP contract."""
    _, tcfg, lines, ws, x = make_case("proposal", n=5, seed=6)
    tl, tw, tx = to_torch(lines, ws, x)
    u = x[4]
    feats = []
    for lvl, res in enumerate(tcfg.resolutions):
        prod = np.ones(tcfg.features_per_level, np.float32)
        for ax in range(3):
            line = tl[lvl][ax].to(torch.bfloat16).float().numpy()
            xx = np.float32(u[ax]) * np.float32(res - 1)
            i = min(int(np.floor(xx)), res - 2)
            w = np.float32(xx - i)
            prod = prod * ((np.float32(1) - w) * line[i] + w * line[i + 1])
        feats.append(prod)
    want = tfg.mlp2_reference(torch.from_numpy(np.concatenate(feats))[None], tw)[0]
    got = tfg.fused_density_mlp(tcfg, tl, tw, tx)[4]
    torch.testing.assert_close(got, want, rtol=0, atol=2**-8 * float(want.abs().max()))


def selection_cases(levels, feat, hidden, out):
    """(sel0, sel1) pairs of 0/1 selection matrices: hidden unit j reads
    feature sel0[j], output o reads hidden unit sel1[o]; over the cases
    the outputs read every level."""
    d = levels * feat
    if out == 1:
        return [([lvl * feat + lvl % feat] * hidden, [lvl % hidden]) for lvl in range(levels)]
    return [([(2 * j + s) % d for j in range(hidden)], [(4 * o + q) % hidden for o in range(out)])
            for s, q in ((0, 0), (1, 3))]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_plain_twin_under_selection_matrices_is_the_bf16_encode(name):
    """With 0/1 selection matrices for W0 and W1 and zero biases every
    product of the MLP is exact and every sum has one nonzero term, so the
    output is relu(bf16(feat)) at the selected features exactly: the
    contract that K1's card test holds the kernel to."""
    levels, _, feat, hidden, out = SCHEDULES[name]
    _, tcfg, lines, _, x = make_case(name, n=509, seed=7)
    tl = [[torch.from_numpy(np.abs(a) + 0.01) for a in axes] for axes in lines]  # positive features
    tables, tx = tfg.pack_tables(tl), torch.from_numpy(x)
    enc = ffc.encode_plain(tcfg.resolutions, feat, tables, tx).to(torch.bfloat16).float()
    bf = torch.bfloat16
    for sel0, sel1 in selection_cases(levels, feat, hidden, out):
        w0 = torch.zeros(levels * feat, hidden)
        w0[sel0, list(range(hidden))] = 1.0
        w1 = torch.zeros(hidden, out)
        w1[sel1, list(range(out))] = 1.0
        got = ffc.density_mlp_plain(tcfg.resolutions, feat, tables, w0.to(bf), torch.zeros(hidden, dtype=bf),
                                    w1.to(bf), torch.zeros(out, dtype=bf), tx)
        assert torch.equal(got, torch.relu(enc[:, [sel0[j] for j in sel1]]))


def test_pack_tables_layout():
    _, tcfg, lines, ws, x = make_case("prop256", n=4)
    tl, _, _ = to_torch(lines, ws, x)
    packed = tfg.pack_tables(tl)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() == 3 * sum(tcfg.resolutions) * tcfg.features_per_level
    # level 1, axis 2 starts after level 0's three tables and level 1's first two
    r0, r1 = tcfg.resolutions[:2]
    f = tcfg.features_per_level
    start = (3 * r0 + 2 * r1) * f
    torch.testing.assert_close(
        packed[start : start + r1 * f].view(r1, f), tl[1][2].to(torch.bfloat16), rtol=0, atol=0
    )


def test_cuda_wrapper_refuses_cpu_and_unknown_shapes():
    _, tcfg, lines, ws, x = make_case("proposal", n=8)
    tl, tw, tx = to_torch(lines, ws, x)
    (k0, b0), (k1, b1) = tw
    bf = torch.bfloat16
    args = [tcfg.resolutions, 8, tfg.pack_tables(tl), k0.to(bf), b0.to(bf), k1.to(bf), b1.to(bf), tx]
    with pytest.raises(ValueError, match="CUDA"):
        ffc.density_mlp_cuda(*args)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        tfg.fused_density_mlp(tcfg, tl, tw, tx.to("meta"))
