"""The gradient-normals slice on the CPU: the plain twins of K3 to K6 (the
contracts the CUDA kernels follow) against the JAX package's XLA
expressions and against its Pallas TPU kernels in interpret mode (K4 and
K6 also at the layouts their tables halves' scatter is built for: samples
in ray order and all in one cell; K5 there and at uniform coordinates);
the autograd Functions around them; the closed-form Jacobian of the scene
contraction; and `factor_density_geo_and_grad` in both of its routes.

Inputs are made with numpy from a seed and handed to both frameworks. The
kernels' contract keeps f32 tap weights, slopes and products over bf16
tables; the XLA expression rounds hat, dhat and every product to bf16, the
Pallas kernels round hat, dhat and their GEMM operands to bf16 on the small
levels. Gradient-like outputs are compared per leaf by norm-relative error:
one flipped bf16 rounding moves single elements by O(value).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.models.fields import NerfactoField as JField
from signerf_tpu.models.fields import factor_density_geo_and_grad as jgeo_and_grad
from signerf_tpu.ops import factor_grid as jfg
from signerf_tpu.ops import fused_factor_pallas as ffp
from signerf_tpu.ops.contraction import contract_to_unit as jcontract_to_unit
from signerf_tpu_torch.convert import state_dict_from_jax
from signerf_tpu_torch.models.fields import NerfactoField, factor_density_geo_and_grad
from signerf_tpu_torch.ops import factor_grid as tfg
from signerf_tpu_torch.ops import fused_factor_cuda as ffc
from signerf_tpu_torch.ops.contraction import contract_to_unit_jacobian

torch.set_num_threads(2)

# Four levels, res 8 to 256: the Pallas kernels' small (dense-hat) and
# large (blocked) level paths both run.
LEVELS, BASE, MAX_RES, F = 4, 8, 256, 4
BOUNDARY = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def make_case(n=256, seed=0):
    rng = np.random.default_rng(seed)
    jcfg = jfg.FactorGridConfig(num_levels=LEVELS, base_res=BASE, max_res=MAX_RES, features_per_level=F)
    tcfg = tfg.FactorGridConfig(num_levels=LEVELS, base_res=BASE, max_res=MAX_RES, features_per_level=F)
    assert jcfg.resolutions == tcfg.resolutions
    lines = [[(rng.standard_normal((r, F)) * 0.3).astype(np.float32) for _ in range(3)] for r in jcfg.resolutions]
    x = rng.random((n, 3)).astype(np.float32)
    x[: len(BOUNDARY)] = BOUNDARY  # u = 0 and u = 1: knots at every level
    g = rng.standard_normal((n, tcfg.out_dim)).astype(np.float32)
    ct = rng.standard_normal((n, 3)).astype(np.float32)
    return jcfg, tcfg, lines, x, g, ct


def jlines(lines):
    return tuple(tuple(jnp.asarray(a) for a in axes) for axes in lines)


def tlines(lines, grad=False):
    return [[torch.from_numpy(a.copy()).requires_grad_(grad) for a in axes] for axes in lines]


def packed(tcfg, lines):
    return tcfg.resolutions, F, tfg.pack_tables(tlines(lines))


def unpack(tcfg, flat):
    out, off = [], 0
    for r in tcfg.resolutions:
        axes = []
        for _ in range(3):
            axes.append(flat[off : off + r * F].view(r, F).numpy())
            off += r * F
        out.append(axes)
    return out


def leaves(tree):
    return [np.asarray(a) for axes in tree for a in axes]


# ---------------------------------------------------------------------------
# K3: the encode
# ---------------------------------------------------------------------------


def test_k3_twin_matches_xla_reference():
    jcfg, tcfg, lines, x, _, _ = make_case()
    ref = np.asarray(jax.jit(lambda l, xx: jfg._encode_reference(jcfg, l, xx))(jlines(lines), jnp.asarray(x)))
    got = ffc.encode_plain(*packed(tcfg, lines), torch.from_numpy(x)).numpy()
    # f32 taps and products here, bf16 there: bf16 noise of the range
    # (measured 0.0022 of max|ref|).
    np.testing.assert_allclose(got, ref, atol=0.01 * float(np.abs(ref).max()))


def test_k3_twin_matches_pallas_interpret():
    jcfg, tcfg, lines, x, _, _ = make_case(seed=1)
    ref = np.asarray(ffp.fused_factor_encode_tpu(
        jcfg.resolutions, F, ffp.pack_tables(jcfg.resolutions, jlines(lines)), jnp.asarray(x), True))
    got = ffc.encode_plain(*packed(tcfg, lines), torch.from_numpy(x)).numpy()
    # The same f32 products; interpret mode keeps bf16 hat weights on its
    # small levels (measured 0.0024 of max|ref|).
    np.testing.assert_allclose(got, ref, atol=0.01 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# K4: the encode's backward
# ---------------------------------------------------------------------------


def test_k4_twin_matches_xla_vjp():
    jcfg, tcfg, lines, x, g, _ = make_case(seed=2)
    _, vjp = jax.vjp(lambda l, xx: jfg._encode_reference(jcfg, l, xx), jlines(lines), jnp.asarray(x))
    gl, gx = vjp(jnp.asarray(g))
    g_tables, g_x = ffc.encode_bwd_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(g), True, True)
    for a, b in zip(leaves(unpack(tcfg, g_tables)), leaves(gl)):
        assert rel(a, b) < 0.02, rel(a, b)  # bf16 products there: measured up to 0.0055
    # Off the knots (the XLA autodiff takes half of both cells' slopes
    # there, the twin 0): measured 0.0051.
    n0 = len(BOUNDARY)
    assert rel(g_x.numpy()[n0:], np.asarray(gx)[n0:]) < 0.02


def test_k4_twin_matches_pallas_interpret():
    jcfg, tcfg, lines, x, g, _ = make_case(seed=3)
    grad_packed, gx = ffp.fused_factor_encode_bwd_tpu(
        jcfg.resolutions, F, ffp.pack_tables(jcfg.resolutions, jlines(lines)), jnp.asarray(x), jnp.asarray(g), True)
    gl = ffp.unpack_table_grads(jcfg.resolutions, grad_packed, F)
    g_tables, g_x = ffc.encode_bwd_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(g), True, True)
    for a, b in zip(leaves(unpack(tcfg, g_tables)), leaves(gl)):
        # Pallas rounds G (small levels) or w G (large) to bf16 before its
        # GEMM, the twin keeps f32: measured up to 0.0040.
        assert rel(a, b) < 0.01, rel(a, b)
    # The same knot rule (0 at an exact knot), boundary rows included:
    # measured 0.00024.
    assert rel(g_x.numpy(), np.asarray(gx)) < 0.01
    np.testing.assert_array_equal(g_x.numpy()[:2], 0.0)  # u in {0, 1} on every axis


# ---------------------------------------------------------------------------
# K5: the grad-dot contraction
# ---------------------------------------------------------------------------


def test_k5_twin_matches_xla_reference_and_is_zero_at_knots():
    jcfg, tcfg, lines, x, g, _ = make_case(seed=4)
    ref = np.asarray(jax.jit(lambda l, xx, gg: jnp.einsum("njd,nd->nj", jfg.dfeat01_reference(jcfg, l, xx), gg))(
        jlines(lines), jnp.asarray(x), jnp.asarray(g)))
    got = ffc.grad_dot_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(g)).numpy()
    # bf16 hat, dhat, (R - 1) and products there: measured 0.0045.
    assert rel(got, ref) < 0.02, rel(got, ref)
    # Exact zeros where an axis sits on a knot at every level (u = 0 or 1),
    # in both versions.
    knots = np.array(BOUNDARY) != 0.5
    assert np.all(got[: len(BOUNDARY)][knots] == 0.0)
    assert np.all(ref[: len(BOUNDARY)][knots] == 0.0)
    assert np.all(got[2:4][~knots[2:4]] != 0.0)


def test_k5_twin_matches_pallas_interpret():
    jcfg, tcfg, lines, x, g, _ = make_case(seed=5)
    ref = np.asarray(ffp.fused_factor_grad_dot_tpu(
        jcfg.resolutions, F, ffp.pack_tables(jcfg.resolutions, jlines(lines)), jnp.asarray(x), jnp.asarray(g), True))
    got = ffc.grad_dot_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert rel(got, ref) < 0.01, rel(got, ref)  # bf16 hat and dhat on the small levels: measured 0.0003
    np.testing.assert_array_equal(ref[:2], 0.0)


# ---------------------------------------------------------------------------
# K6: the grad-dot's backward
# ---------------------------------------------------------------------------


def _k6_twin(tcfg, lines, x, g, ct):
    g_tables, g_g, g_x = ffc.grad_dot_bwd_plain(
        *packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(ct), True, True)
    return leaves(unpack(tcfg, g_tables)), g_x.numpy(), g_g.numpy()


def test_k6_twin_matches_xla_vjp():
    jcfg, tcfg, lines, x, g, ct = make_case(seed=6)
    # A fixed linear cotangent, as tests/test_analytic_normals.py explains:
    # a nonlinear functional would compare the gradients of two different
    # functions at the two versions' slightly different forward values.
    _, vjp = jax.vjp(lambda l, xx, gg: jnp.einsum("njd,nd->nj", jfg.dfeat01_reference(jcfg, l, xx), gg),
                     jlines(lines), jnp.asarray(x), jnp.asarray(g))
    gl, gx, gg = vjp(jnp.asarray(ct))
    lines_t, g_x, g_g = _k6_twin(tcfg, lines, x, g, ct)
    for a, b in zip(lines_t, leaves(gl)):
        assert rel(a, b) < 0.02, rel(a, b)  # bf16 dhat scale and products there: measured up to 0.0059
    assert rel(g_g, gg) < 0.02  # measured 0.0040
    n0 = len(BOUNDARY)  # off the knots: the XLA autodiff's hat slope is the mean of both cells there
    assert rel(g_x[n0:], np.asarray(gx)[n0:]) < 0.02  # measured 0.0040


def test_k6_twin_matches_pallas_interpret():
    jcfg, tcfg, lines, x, g, ct = make_case(seed=7)
    grad_packed, gx, gg = ffp.fused_factor_grad_dot_bwd_tpu(
        jcfg.resolutions, F, ffp.pack_tables(jcfg.resolutions, jlines(lines)), jnp.asarray(x),
        jnp.asarray(g), jnp.asarray(ct), True)
    gl = ffp.unpack_table_grads(jcfg.resolutions, grad_packed, F)
    lines_t, g_x, g_g = _k6_twin(tcfg, lines, x, g, ct)
    for a, b in zip(lines_t, leaves(gl)):
        assert rel(a, b) < 0.01, rel(a, b)  # bf16 GEMM operands there: measured up to 0.0030
    assert rel(g_g, gg) < 0.01  # measured 0.00015
    assert rel(g_x, gx) < 0.01  # the same knot rule, boundary rows included: measured 1.4e-5


# ---------------------------------------------------------------------------
# K4 and K6 at the layouts their tables halves' scatter is built for
# ---------------------------------------------------------------------------

LAYOUTS = ["ray-ordered", "one cell"]
# Line grads, twin against interpret-mode Pallas, per leaf: Pallas rounds G
# (or w G) or its GEMM operands to bf16, 2^-9 of each term. In one cell all
# 256 samples' terms of random sign meet in two rows, so that rounding is
# measured against a sum smaller than its terms: measured up to 0.0045
# (ray-ordered) and 0.0157 (one cell) over seeds 20 to 22.
LINES_TOL = {"ray-ordered": 0.01, "one cell": 0.03}


def layout_case(layout, seed, n=256):
    """make_case with other sample positions: in ray order (32 consecutive
    samples a "ray", in order along a line between two random points of
    the cube), or all inside one cell of every level ("uniform" keeps
    make_case's, boundary rows included)."""
    jcfg, tcfg, lines, x, g, ct = make_case(n=n, seed=seed)
    if layout == "uniform":
        return jcfg, tcfg, lines, x, g, ct
    rng = np.random.default_rng(seed + 100)
    if layout == "ray-ordered":
        a, b = rng.random((n // 32, 1, 3)), rng.random((n // 32, 1, 3))
        t = np.sort(rng.random((n // 32, 32, 1)), axis=1)
        return jcfg, tcfg, lines, (a + (b - a) * t).reshape(n, 3).astype(np.float32), g, ct
    width = 1e-4
    for k in range(1000):
        c = 0.3 + 1e-3 * k
        if all(math.floor(c * (r - 1)) == math.floor((c + width) * (r - 1)) and c * (r - 1) % 1 > 1e-3
               for r in tcfg.resolutions):
            return jcfg, tcfg, lines, (c + width * rng.random((n, 3))).astype(np.float32), g, ct
    raise AssertionError("no point lies inside one cell of every level")


@pytest.mark.parametrize("layout", ["uniform", *LAYOUTS])
def test_k5_twin_matches_pallas_interpret_at_layout(layout):
    """K5's twin at the layouts its kernel's tile meets: samples in ray
    order and all in one cell gather the same rows on neighbouring lanes."""
    jcfg, tcfg, lines, x, g, _ = layout_case(layout, seed=23)
    ref = np.asarray(ffp.fused_factor_grad_dot_tpu(
        jcfg.resolutions, F, ffp.pack_tables(jcfg.resolutions, jlines(lines)), jnp.asarray(x), jnp.asarray(g), True))
    got = ffc.grad_dot_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert got.shape == ref.shape == (len(x), 3)
    # bf16 hat and dhat on the small levels there: measured up to 0.00025 over seeds 23 to 25.
    assert rel(got, ref) < 0.01, rel(got, ref)
    if layout == "uniform":  # u in {0, 1} on every axis of rows 0 and 1: exactly 0 in both
        np.testing.assert_array_equal(ref[:2], 0.0)
        np.testing.assert_array_equal(got[:2], 0.0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_k4_twin_matches_pallas_interpret_at_layout(layout):
    jcfg, tcfg, lines, x, g, _ = layout_case(layout, seed=20)
    grad_packed, gx = ffp.fused_factor_encode_bwd_tpu(
        jcfg.resolutions, F, ffp.pack_tables(jcfg.resolutions, jlines(lines)), jnp.asarray(x), jnp.asarray(g), True)
    gl = ffp.unpack_table_grads(jcfg.resolutions, grad_packed, F)
    g_tables, g_x = ffc.encode_bwd_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(g), True, True)
    for a, b in zip(leaves(unpack(tcfg, g_tables)), leaves(gl)):
        assert rel(a, b) < LINES_TOL[layout], rel(a, b)
    assert rel(g_x.numpy(), np.asarray(gx)) < 0.01  # measured up to 0.0011


@pytest.mark.parametrize("layout", LAYOUTS)
def test_k6_twin_matches_pallas_interpret_at_layout(layout):
    jcfg, tcfg, lines, x, g, ct = layout_case(layout, seed=21)
    grad_packed, gx, gg = ffp.fused_factor_grad_dot_bwd_tpu(
        jcfg.resolutions, F, ffp.pack_tables(jcfg.resolutions, jlines(lines)), jnp.asarray(x),
        jnp.asarray(g), jnp.asarray(ct), True)
    gl = ffp.unpack_table_grads(jcfg.resolutions, grad_packed, F)
    lines_t, g_x, g_g = _k6_twin(tcfg, lines, x, g, ct)
    for a, b in zip(lines_t, leaves(gl)):
        assert rel(a, b) < LINES_TOL[layout], rel(a, b)
    assert rel(g_g, gg) < 0.01  # measured up to 0.0011
    assert rel(g_x, gx) < 0.01  # measured up to 2.4e-5


# ---------------------------------------------------------------------------
# The autograd Functions
# ---------------------------------------------------------------------------


def test_encode_fused_is_the_twin_and_its_vjp():
    """`encode_fused` hands back K3's twin forward and K4's twin grads, as
    f32; torch autograd through the port's own copy of the XLA expression
    agrees within the two contracts' bf16 gap."""
    _, tcfg, lines, x, g, _ = make_case(seed=8)
    tl, tx = tlines(lines, True), torch.from_numpy(x).requires_grad_(True)
    before = [getattr(ffc, c) for c in ffc.COUNTERS]
    out = tfg.encode_fused(tcfg, tl, tx)
    assert torch.equal(out.detach(), ffc.encode_plain(*packed(tcfg, lines), torch.from_numpy(x)))
    out.backward(torch.from_numpy(g))
    g_tables, g_x = ffc.encode_bwd_plain(*packed(tcfg, lines), torch.from_numpy(x), torch.from_numpy(g), True, True)
    for got, want in zip([t.grad for axes in tl for t in axes], leaves(unpack(tcfg, g_tables))):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tx.grad.numpy(), g_x.numpy())
    assert [getattr(ffc, c) for c in ffc.COUNTERS] == before  # a CPU tensor launches nothing
    rl, rx = tlines(lines, True), torch.from_numpy(x).requires_grad_(True)
    tfg._encode_reference(tcfg, rl, rx).backward(torch.from_numpy(g))
    for got, ref in zip([t.grad for axes in tl for t in axes], [t.grad for axes in rl for t in axes]):
        assert rel(got, ref) < 0.02  # measured up to 0.0054; coords 0.0043
    n0 = len(BOUNDARY)
    assert rel(tx.grad[n0:], rx.grad[n0:]) < 0.02


def test_grad_encode_dot_is_the_twin_and_its_vjp(monkeypatch):
    """`grad_encode_dot` hands back K5's twin and K6's twin grads (lines,
    x01 and g); the coords half runs only when x01 needs a gradient;
    autograd through the port's copy of the XLA expression agrees."""
    _, tcfg, lines, x, g, ct = make_case(seed=9)
    calls = []
    real = ffc.grad_dot_bwd_plain
    monkeypatch.setattr(ffc, "grad_dot_bwd_plain", lambda *a, **k: calls.append(k) or real(*a, **k))
    for with_x in (True, False):
        tl = tlines(lines, True)
        tx = torch.from_numpy(x).requires_grad_(with_x)
        tg = torch.from_numpy(g).requires_grad_(True)
        out = tfg.grad_encode_dot(tcfg, tl, tx, tg)
        assert torch.equal(out.detach(), ffc.grad_dot_plain(*packed(tcfg, lines), torch.from_numpy(x),
                                                            torch.from_numpy(g)))
        out.backward(torch.from_numpy(ct))
        assert calls.pop() == {"tables_half": True, "coords_half": with_x}
        want_l, want_x, want_g = _k6_twin(tcfg, lines, x, g, ct)
        for got, want in zip([t.grad for axes in tl for t in axes], want_l):
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tg.grad.numpy(), want_g)
        if with_x:
            np.testing.assert_array_equal(tx.grad.numpy(), want_x)
    rl, rx = tlines(lines, True), torch.from_numpy(x).requires_grad_(True)
    rg = torch.from_numpy(g).requires_grad_(True)
    torch.einsum("njd,nd->nj", tfg.dfeat01_reference(tcfg, rl, rx), rg).backward(torch.from_numpy(ct))
    for got, ref in zip(want_l, [t.grad for axes in rl for t in axes]):
        assert rel(got, ref) < 0.02  # measured up to 0.0063
    assert rel(want_g, rg.grad) < 0.02  # measured 0.0038


def test_dhat_and_dfeat01_reference_match_jax():
    """The port of the XLA expression: the same roundings in the same order."""
    jcfg, tcfg, lines, x, _, _ = make_case(n=64, seed=10)
    for res in (8, 25, 256):
        for dtype, jdtype in [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]:
            ref = np.asarray(jfg.dhat_matrix(jnp.asarray(x[:, 0]), res, jdtype).astype(jnp.float32))
            got = tfg.dhat_matrix(torch.from_numpy(x[:, 0]), res, dtype).float().numpy()
            np.testing.assert_array_equal(got, ref)
    ref = np.asarray(jax.jit(lambda l, xx: jfg.dfeat01_reference(jcfg, l, xx))(jlines(lines), jnp.asarray(x)))
    got = tfg.dfeat01_reference(tcfg, tlines(lines), torch.from_numpy(x)).numpy()
    # bf16 values: a one-ulp flip from the f32 summation order would be
    # 2^-8 relative (measured: identical)
    np.testing.assert_allclose(got, ref, atol=2**-7 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# The contraction's Jacobian
# ---------------------------------------------------------------------------


def test_contraction_jacobian_matches_jax_jvp():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((64, 3)) * 1.5).astype(np.float32)
    x[:8] = [
        [0.3, -0.2, 0.1],  # inside the unit cube
        [1.0, 0.5, -0.2],  # on its face: the inside branch
        [2.0, -2.0, 0.5],  # two axes tie for the max
        [-3.0, 0.2, 3.0],
        [0.1, 4.0, -4.0],
        [1.5, 1.5, -1.5],  # a three-way tie
        [-2.5, -2.5, -2.5],
        [5.0, 0.0, 0.0],  # sign(0) on the others
    ]
    eye = jnp.eye(3)
    ref = np.stack([
        np.asarray(jax.jvp(jcontract_to_unit, (jnp.asarray(x),), (jnp.broadcast_to(eye[i], x.shape),))[1])
        for i in range(3)
    ], axis=-1)
    with torch.inference_mode():
        got = contract_to_unit_jacobian(torch.from_numpy(x)).numpy()
    # The same f32 formula, differentiated by hand: 1e-6 relative. JAX's
    # max splits a tie 1/2 : 1/2 at each of its two nested maxima, and the
    # closed form follows it, ties included.
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# factor_density_geo_and_grad
# ---------------------------------------------------------------------------

FIELD = dict(num_images=2, factor_num_levels=3, base_res=4, max_res=16, factor_features_per_level=4,
             hidden_dim=16, geo_feat_dim=7)


@pytest.fixture(scope="module")
def fields():
    jfield = JField(encoding_backend="factor", **FIELD)
    pos = (np.random.default_rng(12).random((8, 8, 3)) * 3.0 - 1.5).astype(np.float32)  # inside and outside
    params = jfield.init(jax.random.PRNGKey(1), jnp.asarray(pos), jnp.ones((8, 3)) / jnp.sqrt(3.0),
                         jnp.zeros((8,), jnp.int32), False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tfield = NerfactoField(**FIELD)
    tfield.load_state_dict(state_dict_from_jax(params), strict=True)
    return jfield, params, tfield, pos


def test_geo_and_grad_xla_route_matches_jax(fields):
    """The port's XLA route against the JAX XLA branch (both bf16 fields):
    the same expression with the same roundings; only the contraction
    Jacobian (closed form here, jax.jvp there) and f32 summation order
    differ (measured: density 8e-8 relative, geo identical, gradient 5e-8
    norm-relative)."""
    jfield, params, tfield, pos = fields
    jd, jg, jgr = (np.asarray(a) for a in jgeo_and_grad(params, jnp.asarray(pos), jfield))
    td, tg, tgr = (a.detach().numpy() for a in factor_density_geo_and_grad(tfield, torch.from_numpy(pos), xla=True))
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)
    assert rel(tgr, jgr) < 1e-5, rel(tgr, jgr)


def test_geo_and_grad_kernel_route_matches_both_jax_branches(fields, monkeypatch):
    """The kernel route (K3 and K5's twins here) against the JAX XLA branch
    and against its fused branch with the Pallas kernels in interpret mode,
    with the tolerances tests/test_analytic_normals.py allows the fused
    branch; and once under torch.inference_mode()."""
    jfield, params, tfield, pos = fields
    td, tg, tgr = (a.detach().numpy() for a in factor_density_geo_and_grad(tfield, torch.from_numpy(pos)))
    with torch.inference_mode():
        outs = factor_density_geo_and_grad(tfield, torch.from_numpy(pos))
    for a, b in zip(outs, (td, tg, tgr)):
        np.testing.assert_array_equal(a.numpy(), b)
    refs = {"xla": [np.asarray(a) for a in jgeo_and_grad(params, jnp.asarray(pos), jfield)]}
    monkeypatch.setattr(ffp, "FORCE_INTERPRET", True)
    refs["pallas"] = [np.asarray(a) for a in jgeo_and_grad(params, jnp.asarray(pos), jfield)]
    for name, (jd, jg, jgr) in refs.items():
        np.testing.assert_allclose(td, jd, rtol=0.05, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(tg, jg, rtol=0.05, atol=5e-2, err_msg=name)
        assert rel(tgr, jgr) < 0.05, (name, rel(tgr, jgr))  # measured 0.0045 (xla), 0.0018 (pallas)
        scale = max(float(np.abs(jgr).max()), 1e-3)
        np.testing.assert_allclose(tgr, jgr, atol=0.3 * scale, err_msg=name)


def test_detached_grad_cuts_the_g_path_as_jax_fused_does(fields, monkeypatch):
    """The JAX fused branch with differentiable_grad=False detaches s01
    whole (fields.py:466-467), so d/dparams of the gradient keeps only its
    density factor's path, and the g path into w0 and w1 is cut too. The
    kernel route reproduces that on purpose; the XLA routes of both
    packages stay differentiable."""
    jfield, params, tfield, pos = fields
    monkeypatch.setattr(ffp, "FORCE_INTERPRET", True)

    def jloss(p):
        return jnp.sum(jgeo_and_grad(p, jnp.asarray(pos), jfield, differentiable_grad=False)[2])

    jgrads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params)))
    got = {}
    for xla in (False, True):
        tfield.zero_grad()
        factor_density_geo_and_grad(tfield, torch.from_numpy(pos), xla=xla)[2].sum().backward()
        got[xla] = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                    for n, p in tfield.named_parameters()}
    density_only = ["mlp_base.dense_1.kernel", "mlp_base.dense_0.kernel", "encoding.line_2_0"]
    for name in density_only:
        # only the density factor's path: the same gradient (measured up to 0.0058)
        assert rel(got[False][name], jgrads[name]) < 0.05, (name, rel(got[False][name], jgrads[name]))
        # with the g path the XLA route's gradient is another one (measured 540 to 860 times larger)
        assert rel(got[True][name], got[False][name]) > 0.05, name
