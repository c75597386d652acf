"""The last three factor-grid kernels on the CPU: the plain twins of K8
(the encode's uncontracted spatial derivative), K9 (its backward) and K10
(the early dense-hat encode) against the JAX package's XLA expressions and
its Pallas TPU kernels in interpret mode (K9 also with samples in ray order
and all in one cell); the autograd Functions around them
(`grad_encode_fused`, `fused_factor_grad`, `factor_encode_kernel`).

Inputs are made with numpy from a seed and handed to both frameworks. The
schedules are the base field (F = 16) and a proposal field (F = 8) cut to
three levels, with resolutions past the Pallas kernels' small-level limit
(64) so both of their level paths run. Gradient-like outputs are compared
per leaf by norm-relative error: one flipped bf16 rounding moves single
elements by O(value).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from signerf_tpu.ops import factor_grid as jfg
from signerf_tpu.ops import fused_factor_pallas as ffp
from signerf_tpu.ops.pallas import factor_grid_kernel as jfk
from signerf_tpu_torch.ops import factor_grid as tfg
from signerf_tpu_torch.ops import fused_factor_cuda as ffc
from signerf_tpu_torch.ops.factor_grid_kernel import factor_encode_kernel

torch.set_num_threads(2)

# (levels, base_res, max_res, F)
SCHEDULES = {"base": (3, 16, 256, 16), "proposal": (3, 16, 128, 8)}
BOUNDARY = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def make_case(name, n=128, seed=0):
    levels, base, max_res, feat = SCHEDULES[name]
    rng = np.random.default_rng(seed)
    kw = dict(num_levels=levels, base_res=base, max_res=max_res, features_per_level=feat)
    jcfg, tcfg = jfg.FactorGridConfig(**kw), tfg.FactorGridConfig(**kw)
    assert jcfg.resolutions == tcfg.resolutions
    lines = [[(rng.standard_normal((r, feat)) * 0.3).astype(np.float32) for _ in range(3)] for r in jcfg.resolutions]
    x = rng.random((n, 3)).astype(np.float32)
    x[: len(BOUNDARY)] = BOUNDARY  # u = 0 and u = 1: knots at every level
    ct = rng.standard_normal((n, 3, tcfg.out_dim)).astype(np.float32)
    return jcfg, tcfg, lines, x, ct


def jlines(lines):
    return tuple(tuple(jnp.asarray(a) for a in axes) for axes in lines)


def tlines(lines, grad=False):
    return [[torch.from_numpy(a.copy()).requires_grad_(grad) for a in axes] for axes in lines]


def packed(tcfg, lines):
    return tcfg.resolutions, tcfg.features_per_level, tfg.pack_tables(tlines(lines))


def unpack(tcfg, flat):
    out, off, feat = [], 0, tcfg.features_per_level
    for r in tcfg.resolutions:
        axes = []
        for _ in range(3):
            axes.append(flat[off : off + r * feat].view(r, feat).numpy())
            off += r * feat
        out.append(axes)
    return out


def leaves(tree):
    return [np.asarray(a) for axes in tree for a in axes]


# ---------------------------------------------------------------------------
# K8: d feat / d pos01, [N, 3, D]
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k8_twin_matches_xla_reference(name):
    jcfg, tcfg, lines, x, _ = make_case(name)
    ref = np.asarray(jfg.dfeat01_reference(jcfg, jlines(lines), jnp.asarray(x)))
    got = ffc.grad_plain(*packed(tcfg, lines), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (len(x), 3, tcfg.out_dim) and got.dtype == np.float32
    # f32 taps and products here, bf16 hat, dhat and products there
    # (measured 0.0046 base, 0.0044 proposal).
    assert rel(got, ref) < 0.02, rel(got, ref)
    np.testing.assert_array_equal(ref[:2], 0.0)
    np.testing.assert_array_equal(got[:2], 0.0)  # every axis at a knot of every level


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k8_twin_matches_pallas_interpret(name):
    jcfg, tcfg, lines, x, _ = make_case(name, seed=1)
    ref = np.asarray(ffp._fused_factor_grad_impl(
        jcfg.resolutions, jcfg.features_per_level, ffp.pack_tables(jcfg.resolutions, jlines(lines)),
        jnp.asarray(x), True))
    got = ffc.grad_plain(*packed(tcfg, lines), torch.from_numpy(x)).numpy()
    # The same f32 products; interpret mode rounds hat and dhat to bf16 on
    # its small levels (measured 0.00053 base, 0.00079 proposal).
    assert rel(got, ref) < 0.005, rel(got, ref)
    # Exact zeros at the knots, in both: the slope of an axis at u = 0 or 1
    # is 0, so rows 0 and 1 are 0 everywhere, and row 2's axis 1 (u = 0)
    # zeroes its own derivative and its place in the other two.
    for out in (got, ref):
        np.testing.assert_array_equal(out[:2], 0.0)
        np.testing.assert_array_equal(out[2:4, 1], 0.0)


# ---------------------------------------------------------------------------
# K9: K8's VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k9_twin_matches_pallas_interpret(name):
    jcfg, tcfg, lines, x, ct = make_case(name, seed=2)
    feat = jcfg.features_per_level
    grad_packed, gx = ffp.fused_factor_grad_bwd_tpu(
        jcfg.resolutions, feat, ffp.pack_tables(jcfg.resolutions, jlines(lines)), jnp.asarray(x),
        jnp.asarray(ct), True)
    gl = ffp.unpack_table_grads(jcfg.resolutions, grad_packed, feat)
    g_tables, g_x = ffc.grad_bwd_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(ct), True, True)
    for a, b in zip(leaves(unpack(tcfg, g_tables)), leaves(gl)):
        # Pallas rounds G_hat, G_dhat (or the tap-weighted sums) to bf16
        # before its GEMMs, the twin keeps f32 (measured up to 0.0029).
        assert rel(a, b) < 0.01, rel(a, b)
    # The same knot rule, boundary rows included (measured up to 1.9e-4).
    assert rel(g_x.numpy(), np.asarray(gx)) < 1e-3, rel(g_x.numpy(), np.asarray(gx))
    np.testing.assert_array_equal(g_x.numpy()[:2], 0.0)


def layout_x(layout, resolutions, n, seed):
    """[n, 3] sample positions in ray order (32 consecutive samples a "ray",
    in order along a line between two random points of the cube) or all
    inside one cell of every level, as tests/test_torch_normals.py lays
    them out."""
    rng = np.random.default_rng(seed + 100)
    if layout == "ray-ordered":
        a, b = rng.random((n // 32, 1, 3)), rng.random((n // 32, 1, 3))
        t = np.sort(rng.random((n // 32, 32, 1)), axis=1)
        return (a + (b - a) * t).reshape(n, 3).astype(np.float32)
    width = 1e-4
    for k in range(1000):
        c = 0.3 + 1e-3 * k
        if all(math.floor(c * (r - 1)) == math.floor((c + width) * (r - 1)) and c * (r - 1) % 1 > 1e-3
               for r in resolutions):
            return (c + width * rng.random((n, 3))).astype(np.float32)
    raise AssertionError("no point lies inside one cell of every level")


@pytest.mark.parametrize("layout", ["uniform", "ray-ordered", "one cell"])
def test_k9_twin_matches_pallas_interpret_at_layout(layout):
    """K9's twin at the layouts its tables half's scatter is built for (base
    field; uniform keeps make_case's boundary rows)."""
    jcfg, tcfg, lines, x, ct = make_case("base", n=256, seed=30)
    if layout != "uniform":
        x = layout_x(layout, tcfg.resolutions, len(x), seed=30)
    feat = jcfg.features_per_level
    grad_packed, gx = ffp.fused_factor_grad_bwd_tpu(
        jcfg.resolutions, feat, ffp.pack_tables(jcfg.resolutions, jlines(lines)), jnp.asarray(x),
        jnp.asarray(ct), True)
    gl = ffp.unpack_table_grads(jcfg.resolutions, grad_packed, feat)
    g_tables, g_x = ffc.grad_bwd_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(ct), True, True)
    for a, b in zip(leaves(unpack(tcfg, g_tables)), leaves(gl)):
        # Pallas rounds G_hat, G_dhat (or the tap-weighted sums) to bf16
        # before its GEMMs: measured up to 0.0046 (one cell) over seeds 30
        # to 32.
        assert rel(a, b) < 0.01, rel(a, b)
    # The same knot rule (measured up to 1.1e-4).
    assert rel(g_x.numpy(), np.asarray(gx)) < 1e-3, rel(g_x.numpy(), np.asarray(gx))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k9_twin_matches_xla_vjp(name):
    jcfg, tcfg, lines, x, ct = make_case(name, seed=3)
    _, vjp = jax.vjp(lambda l, xx: jfg.dfeat01_reference(jcfg, l, xx), jlines(lines), jnp.asarray(x))
    gl, gx = vjp(jnp.asarray(ct))
    g_tables, g_x = ffc.grad_bwd_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(ct), True, True)
    for a, b in zip(leaves(unpack(tcfg, g_tables)), leaves(gl)):
        assert rel(a, b) < 0.02, rel(a, b)  # bf16 products there (measured up to 0.0057)
    # Off the knots (XLA's autodiff of relu and |.| takes half of both
    # cells' slopes there, the twin 0): measured up to 0.0047.
    n0 = len(BOUNDARY)
    assert rel(g_x.numpy()[n0:], np.asarray(gx)[n0:]) < 0.02


def test_k9_halves_are_separate():
    _, tcfg, lines, x, ct = make_case("proposal", n=64, seed=4)
    args = (*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(ct))
    both = ffc.grad_bwd_plain(*args, True, True)
    only_tables = ffc.grad_bwd_plain(*args)
    only_coords = ffc.grad_bwd_plain(*args, False, True)
    assert only_tables[1] is None and only_coords[0] is None
    torch.testing.assert_close(only_tables[0], both[0], rtol=0, atol=0)
    torch.testing.assert_close(only_coords[1], both[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The autograd Functions
# ---------------------------------------------------------------------------


def test_grad_encode_fused_matches_jax(monkeypatch):
    """The port's `grad_encode_fused` against the JAX one with its Pallas
    kernels in interpret mode (K8 forward, K9 backward), as
    tests/test_analytic_normals.py drives it."""
    monkeypatch.setattr(ffp, "FORCE_INTERPRET", True)
    jcfg, tcfg, lines, x, ct = make_case("base", n=96, seed=5)
    jl, jx, jct = jlines(lines), jnp.asarray(x), jnp.asarray(ct)
    ref = np.asarray(jfg.grad_encode_fused(jcfg, jl, jx))
    gl_j, gx_j = jax.grad(lambda l, xx: jnp.sum(jfg.grad_encode_fused(jcfg, l, xx) * jct), argnums=(0, 1))(jl, jx)

    tl = tlines(lines, grad=True)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    out = tfg.grad_encode_fused(tcfg, tl, tx)
    (out * torch.from_numpy(ct)).sum().backward()
    assert rel(out.detach().numpy(), ref) < 0.005  # as the K8 twin vs interpret mode
    for a, b in zip([t.grad.numpy() for axes in tl for t in axes], leaves(gl_j)):
        assert rel(a, b) < 0.01, rel(a, b)  # as the K9 twin vs interpret mode
    assert rel(tx.grad.numpy(), np.asarray(gx_j)) < 1e-3


def test_grad_encode_fused_skips_what_needs_no_grad():
    _, tcfg, lines, x, ct = make_case("proposal", n=64, seed=6)
    tl = tlines(lines, grad=True)
    tx = torch.from_numpy(x.copy())  # no grad: K9's coords half does not run
    out = tfg.grad_encode_fused(tcfg, tl, tx)
    (out * torch.from_numpy(ct)).sum().backward()
    assert tx.grad is None and all(t.grad is not None for axes in tl for t in axes)
    want, _ = ffc.grad_bwd_plain(*packed(tcfg, lines), tx, torch.from_numpy(ct))
    got = torch.cat([t.grad.reshape(-1) for axes in tl for t in axes])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_factor_grad_has_a_zero_vjp():
    """`fused_factor_grad` is K8 with a zero VJP (`fused_factor_grad_tpu`'s
    custom_vjp): its output takes part in autograd and hands back zeros,
    where `.detach()` would leave the output without a grad_fn."""
    _, tcfg, lines, x, ct = make_case("base", n=64, seed=7)
    tl = tlines(lines, grad=True)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    out = tfg.fused_factor_grad(tcfg, tl, tx)
    torch.testing.assert_close(out, tfg.grad_encode_fused(tcfg, tl, tx).detach(), rtol=0, atol=0)
    assert out.requires_grad and out.grad_fn is not None
    (out * torch.from_numpy(ct)).sum().backward()
    grads = [tx.grad] + [t.grad for axes in tl for t in axes]
    assert all(g is not None and g.shape == t.shape and not g.any()
               for g, t in zip(grads, [tx] + [t for axes in tl for t in axes]))
    detached = tfg.grad_encode_fused(tcfg, tl, tx).detach()
    assert not detached.requires_grad
    with pytest.raises(RuntimeError):
        (detached * torch.from_numpy(ct)).sum().backward()


# ---------------------------------------------------------------------------
# K10: the early dense-hat encode
# ---------------------------------------------------------------------------


def flat(lines):
    return tuple(a for axes in lines for a in axes)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k10_twin_matches_pallas_interpret(name):
    jcfg, tcfg, lines, x, _ = make_case(name, n=300, seed=8)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfk.factor_encode_pallas(jnp.asarray(x), flat(jlines(lines)), jcfg.resolutions))
    got = factor_encode_kernel(torch.from_numpy(x), flat(tlines(lines)), tcfg.resolutions).numpy()
    assert got.shape == ref.shape == (len(x), tcfg.out_dim) and got.dtype == np.float32
    # The same contract: bf16 hat weights, exact products with the bf16
    # rows, one f32 rounding of their sum, f32 products across the axes
    # (measured bit-equal).
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k10_twin_matches_forward_ref_and_k3(name):
    jcfg, tcfg, lines, x, _ = make_case(name, n=300, seed=9)
    ref = np.asarray(jfk._forward_ref(jnp.asarray(x), flat(jlines(lines)), jcfg.resolutions))
    got = ffc.dense_encode_plain(*packed(tcfg, lines), torch.from_numpy(x))
    # `_forward_ref` rounds each axis' value to bf16 before the product:
    # bf16 noise of the range (measured up to 0.0032 of max|ref|).
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=0.01 * float(np.abs(ref).max()))
    # K3's contract keeps the tap weights in f32; the two differ by the
    # bf16 rounding of the weights (relative 2^-9 each, three axes;
    # measured up to 0.0032 of max|K3|).
    k3 = ffc.encode_plain(*packed(tcfg, lines), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), k3.numpy(), rtol=0, atol=0.01 * float(k3.abs().max()))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k10_vjp_matches_jax_vjp(name):
    jcfg, tcfg, lines, x, _ = make_case(name, n=200, seed=10)
    rng = np.random.default_rng(11)
    g = rng.standard_normal((len(x), tcfg.out_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, ls: jfk._forward_ref(xx, ls, jcfg.resolutions), jnp.asarray(x),
                     flat(jlines(lines)))
    gx_j, gl_j = vjp(jnp.asarray(g))
    with pltpu.force_tpu_interpret_mode():  # factor_encode_pallas's own custom VJP
        gx_p, gl_p = jax.vjp(lambda xx, ls: jfk.factor_encode_pallas(xx, ls, jcfg.resolutions), jnp.asarray(x),
                             flat(jlines(lines)))[1](jnp.asarray(g))
    tl = flat(tlines(lines, grad=True))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    (factor_encode_kernel(tx, tl, tcfg.resolutions) * torch.from_numpy(g)).sum().backward()
    for a, b, c in zip([t.grad.numpy() for t in tl], gl_j, gl_p):
        # bf16 products of `_forward_ref` there (measured up to 0.0053)
        assert rel(a, b) < 0.02 and rel(a, c) < 0.02, (rel(a, b), rel(a, c))
    # Off the knots: XLA's autodiff takes half of each cell's slope at one
    # (measured up to 0.0045).
    n0 = len(BOUNDARY)
    assert rel(tx.grad.numpy()[n0:], np.asarray(gx_j)[n0:]) < 0.02
    assert rel(tx.grad.numpy()[n0:], np.asarray(gx_p)[n0:]) < 0.02
    np.testing.assert_array_equal(tx.grad.numpy()[:2], 0.0)  # the port's knot rule


def test_factor_encode_kernel_refuses_bad_tables():
    _, tcfg, lines, x, _ = make_case("proposal", n=8)
    tl = flat(tlines(lines))
    with pytest.raises(ValueError, match="3 per level"):
        factor_encode_kernel(torch.from_numpy(x), tl[:-1], tcfg.resolutions)
    with pytest.raises(ValueError, match="shape"):
        factor_encode_kernel(torch.from_numpy(x), tl, tuple(r + 1 for r in tcfg.resolutions))


def test_cuda_wrappers_refuse_cpu_tensors():
    """On the CPU the entry points take the twins; the kernels themselves
    take CUDA tensors only and say so."""
    _, tcfg, lines, x, ct = make_case("base", n=8)
    args = (*packed(tcfg, lines), torch.from_numpy(x))
    for call in (lambda: ffc.grad_cuda(*args), lambda: ffc.dense_encode_cuda(*args),
                 lambda: ffc.grad_bwd_cuda(*args, torch.from_numpy(ct))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
