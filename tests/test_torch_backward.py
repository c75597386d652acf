"""K2, the backward of the encode + density MLP, on the CPU: its plain twin
(`density_mlp_bwd_plain`, the contract the CUDA kernel follows) against the
JAX package's XLA VJP, against the Pallas TPU kernel in interpret mode, and
against torch autograd of the port's own forward; the autograd Function
around it; and the `trunc_exp` gradient.

Inputs are made with numpy from a seed and handed to both frameworks.
Gradients are compared per leaf by norm-relative error: bf16 rounding makes
single elements of gradient-like outputs differ by O(value) between
contracts, while the norm-relative error stays at bf16-noise level.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.models.fields import trunc_exp as jtrunc_exp
from signerf_tpu.ops import factor_grid as jfg
from signerf_tpu.ops import fused_factor_pallas as ffp
from signerf_tpu_torch.models.fields import trunc_exp
from signerf_tpu_torch.ops import factor_grid as tfg
from signerf_tpu_torch.ops import fused_factor_cuda as ffc
from tests.test_torch_factor_grid import BOUNDARY, SCHEDULES, make_case, to_jax, to_torch

torch.set_num_threads(2)

BF = torch.bfloat16


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def cotangent(n, out, seed=9):
    return np.random.default_rng(seed).standard_normal((n, out)).astype(np.float32)


def plain_bwd(tcfg, lines, ws, x, g, coords=True):
    """K2's plain twin -> (line grads [level][axis], (dW0, db0, dW1, db1), coords grad)."""
    tl, tw, tx = to_torch(lines, ws, x)
    (k0, b0), (k1, _) = tw
    g_tables, g_ws, g_x = ffc.density_mlp_bwd_plain(
        tcfg.resolutions, tcfg.features_per_level, tfg.pack_tables(tl),
        k0.to(BF), b0.to(BF), k1.to(BF), tx, torch.from_numpy(g), coords_half=coords,
    )
    g_lines, off = [], 0
    for axes in tl:
        per_axis = []
        for t in axes:
            per_axis.append(g_tables[off : off + t.numel()].view(t.shape).numpy())
            off += t.numel()
        g_lines.append(per_axis)
    return g_lines, [t.numpy() for t in g_ws], None if g_x is None else g_x.numpy()


def leaves(g_lines, g_ws, g_x):
    return [a for axes in g_lines for a in axes] + list(g_ws) + [g_x]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_plain_twin_matches_xla_vjp(name):
    jcfg, tcfg, lines, ws, x = make_case(name, seed=3)
    g = cotangent(x.shape[0], SCHEDULES[name][4])
    got = leaves(*plain_bwd(tcfg, lines, ws, x, g))
    jl, jw, jx = to_jax(lines, ws, x)
    _, vjp = jax.jit(lambda l, w, xx: jax.vjp(lambda *a: jfg.density_mlp_reference(jcfg, *a), l, w, xx))(jl, jw, jx)
    gl, gw, gx = vjp(jnp.asarray(g))
    want = [a for axes in gl for a in axes] + [a for kb in gw for a in kb] + [gx]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got[:-1], want[:-1])):
        assert a.shape == b.shape and a.dtype == np.float32
        # Two bf16 contracts (f32 taps and products here, bf16 hat weights
        # and products there): tests/test_fused_factor.py allows the Pallas
        # kernel 0.08 against this reference at N = 64; here the line grads
        # and dW measured up to 0.088. The biases get 0.2: db0 is summed
        # before rounding here and after there (measured up to 0.143), and
        # the XLA VJP sums the bf16 bias cotangents in bf16 (db1, a single
        # entry at the proposal schedules, measured 0.107).
        bias = i in (len(got) - 4, len(got) - 2)
        assert rel(a, b) < (0.2 if bias else 0.1), (i, rel(a, b))
    # Coordinates off the knots (the first rows sit on u = 0 or u = 1,
    # where each version takes another one-sided rule; see the knot test).
    n0 = len(BOUNDARY)
    assert rel(got[-1][n0:], np.asarray(gx)[n0:]) < 0.06  # measured <= 0.036 (final)


@pytest.mark.parametrize("name", ["proposal", "final"])
def test_plain_twin_matches_pallas_interpret(name, monkeypatch):
    """The TPU kernel itself, run the way tests/test_fused_factor.py runs it
    on the CPU (interpret mode, unjitted), at N = 64."""
    jcfg, tcfg, lines, ws, x = make_case(name, n=64, seed=4)
    g = cotangent(64, SCHEDULES[name][4], seed=5)
    got = leaves(*plain_bwd(tcfg, lines, ws, x, g))
    monkeypatch.setattr(ffp, "FORCE_INTERPRET", True)
    jl, jw, jx = to_jax(lines, ws, x)
    (k0, b0), (k1, b1) = jw
    t0 = time.perf_counter()
    grad_packed, g_ws, gx = ffp.fused_factor_density_bwd_tpu(
        jcfg.resolutions, jcfg.features_per_level, ffp.pack_tables(jcfg.resolutions, jl),
        jx, k0, b0, k1, b1, jnp.asarray(g), True,
    )
    gl = ffp.unpack_table_grads(jcfg.resolutions, grad_packed, jcfg.features_per_level)
    assert time.perf_counter() - t0 < 60  # measured 3.9 s (proposal) and 8.8 s (final) on a CPU
    want = [a for axes in gl for a in axes] + list(g_ws) + [gx]
    for a, b in zip(got[:-1], want[:-1]):
        assert a.shape == b.shape
        # Same rounding points in the MLP VJP; interpret mode keeps bf16
        # tap weights at res <= 64 and rounds G or w*G to bf16 before its
        # GEMM, the port keeps f32: measured up to 0.0036.
        assert rel(a, b) < 0.01, rel(a, b)
    n0 = len(BOUNDARY)  # u = 0 / u = 1 rows: the Pallas knot rule gives 0
    assert rel(got[-1][n0:], np.asarray(gx)[n0:]) < 0.01  # measured up to 7.2e-4


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_plain_twin_is_the_vjp_of_the_plain_forward(name):
    """torch autograd through `density_mlp_plain` takes the same VJP at the
    same rounding points, except that autograd rounds dW to bf16 at the end
    (through the weight's bf16 cast) and sums db0 over bf16 g_h."""
    _, tcfg, lines, ws, x = make_case(name, seed=6)
    g = cotangent(x.shape[0], SCHEDULES[name][4], seed=7)
    got = leaves(*plain_bwd(tcfg, lines, ws, x, g))
    tl, tw, tx = to_torch(lines, ws, x)
    params = [t for axes in tl for t in axes] + [p for kb in tw for p in kb] + [tx]
    for p in params:
        p.requires_grad_(True)
    (k0, b0), (k1, b1) = tw
    out = ffc.density_mlp_plain(tcfg.resolutions, tcfg.features_per_level, tfg.pack_tables(tl), k0, b0, k1, b1, tx)
    out.backward(torch.from_numpy(g))
    for i, (a, p) in enumerate(zip(got, params)):
        want = p.grad.numpy()
        if i == len(got) - 4:  # db0: f32 sum of g_h vs sum of bf16(g_h), measured 0.0017
            assert rel(a, want) < 0.01
        else:  # one bf16 rounding (2^-8) at most, measured 0.0022
            assert rel(a, want) < 0.004, (i, rel(a, want))


def test_knot_rule_is_the_cell_read():
    """At u * (R - 1) integer the coordinate gradient is the slope of the
    cell K1 reads: at u = 0 that of the first cell, at u = 1 that of the
    last one, so it equals the gradient a hair inside that cell."""
    _, tcfg, lines, ws, x = make_case("proposal", n=257, seed=8)
    g = cotangent(257, 1, seed=1)
    _, _, g_x = plain_bwd(tcfg, lines, ws, x, g)
    assert np.isfinite(g_x).all()
    for row, inside in [(0, 1e-7), (1, float(np.nextafter(np.float32(1), np.float32(0))))]:  # BOUNDARY: u = 0 and u = 1 on every axis
        xx = np.full((1, 3), inside, np.float32)
        _, _, g_in = plain_bwd(tcfg, lines, ws, xx, g[[row]])
        # Same cell, w moved by under 2e-5: only a bf16 rounding of a
        # feature or of g_feat could flip; the other rules differ by O(1)
        # (Pallas: 0; XLA: the mean of both neighbouring cells' slopes).
        np.testing.assert_allclose(g_x[row], g_in[0], rtol=0.02, atol=1e-6)
        assert np.abs(g_x[row]).max() > 0  # not the Pallas rule's 0


@pytest.mark.parametrize("name", ["proposal", "final"])
def test_function_backward_is_the_plain_twin(name, monkeypatch):
    """`fused_density_mlp(...).backward(g)` on CPU tensors hands back exactly
    the plain twin's grads, as f32, and asks for the coordinate half only
    when x01 needs a gradient."""
    _, tcfg, lines, ws, x = make_case(name, seed=10)
    g = cotangent(x.shape[0], SCHEDULES[name][4], seed=11)
    want = leaves(*plain_bwd(tcfg, lines, ws, x, g))
    calls = []
    real = ffc.density_mlp_bwd_plain

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(ffc, "density_mlp_bwd_plain", spy)
    for with_x in (True, False):
        tl, tw, tx = to_torch(lines, ws, x)
        params = [t for axes in tl for t in axes] + [p for kb in tw for p in kb]
        for p in params + ([tx] if with_x else []):
            p.requires_grad_(True)
        tfg.fused_density_mlp(tcfg, tl, tw, tx).backward(torch.from_numpy(g))
        for p, w in zip(params + ([tx] if with_x else []), want):
            assert p.grad.dtype == torch.float32
            np.testing.assert_array_equal(p.grad.numpy(), w)
        assert calls[-1]["coords_half"] is with_x and calls[-1]["tables_half"] is True
        assert tx.grad is None or with_x


def test_trunc_exp_gradient_matches_jax():
    """The clamped exp's derivative is that clamped exp everywhere, also
    outside [-15, 15] (the parent tree's gradient was 0 there)."""
    xs = np.array([-20.0, -15.5, -1.0, 0.0, 3.0, 16.0], np.float32)
    want = np.asarray(jax.vmap(jax.grad(jtrunc_exp))(jnp.asarray(xs)))
    x = torch.from_numpy(xs).requires_grad_(True)
    (got,) = torch.autograd.grad(trunc_exp(x).sum(), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)  # the same f32 exp
    np.testing.assert_allclose(
        trunc_exp(torch.from_numpy(xs)).numpy(), np.asarray(jtrunc_exp(jnp.asarray(xs))), rtol=1e-6
    )
