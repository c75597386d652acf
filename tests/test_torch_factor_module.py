"""The factor encoding's own module in the port against the JAX package's:
`FactorGridEncoding` with and without planes under both `use_fused`
values (features and VJP), `encode_with_grad` (values and VJP w.r.t. the
lines), the XLA functions `cp_level_features` and `plane_features` alone,
the config's knobs and `normalize_aabb`.

Inputs are numpy arrays from a seed handed to both frameworks; the JAX
module runs as its own tests run it on the CPU (the XLA path). The port's
default path on the CPU is the kernels' plain twins (K3, K4, K8, K9: f32
taps and products over bf16 tables), the JAX path rounds hat weights and
products to bf16, so the two agree to bf16 rounding of the output's scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from signerf_tpu.ops import contraction as jct
from signerf_tpu.ops import factor_grid as jfg
from signerf_tpu_torch.models import fields as tfields
from signerf_tpu_torch.ops import contraction as tct
from signerf_tpu_torch.ops import factor_grid as tfg
from signerf_tpu_torch.ops import fused_factor_cuda as ffc

torch.set_num_threads(2)

# tests/test_factor_grid.py's module config, with and without planes
KW = dict(num_levels=3, base_res=4, max_res=16, features_per_level=4)
PLANES = dict(include_planes=True, plane_res=8, plane_features=2)
BOUNDARY = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def case(planes: bool, seed: int = 0, shape=(5, 7)):
    """(jax config, port module with the params, params as numpy, x, ct)."""
    kw = {**KW, **(PLANES if planes else {})}
    jcfg, tcfg = jfg.FactorGridConfig(**kw), tfg.FactorGridConfig(**kw)
    rng = np.random.default_rng(seed)
    params = {
        f"line_{lvl}_{ax}": (rng.standard_normal((r, tcfg.features_per_level)) * 0.5).astype(np.float32)
        for lvl, r in enumerate(tcfg.resolutions) for ax in range(3)
    }
    if planes:
        for a, b in ((0, 1), (0, 2), (1, 2)):
            params[f"plane_{a}{b}"] = (rng.standard_normal((8, 8, 2)) * 0.5).astype(np.float32)
    enc = tfields.FactorGridEncoding(tcfg)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=True)
    x = rng.uniform(-0.1, 1.1, (*shape, 3)).astype(np.float32)  # some outside: clipped
    x.reshape(-1, 3)[: len(BOUNDARY)] = BOUNDARY
    ct = rng.standard_normal((*shape, tcfg.out_dim)).astype(np.float32)
    return jcfg, enc, params, x, ct


def jax_module_vjp(jcfg, params, x, ct):
    """JAX's module output and the VJP of ct w.r.t. its params and x."""
    enc = jfg.FactorGridEncoding(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out, vjp = jax.vjp(lambda p, xx: enc.apply({"params": p}, xx), jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def test_config_knobs_and_defaults_match_jax():
    for f in dataclasses.fields(jfg.FactorGridConfig):
        assert getattr(tfg.FactorGridConfig(), f.name) == getattr(jfg.FactorGridConfig(), f.name), f.name
    for kw in (KW, {**KW, **PLANES}, {**KW, "compute_dtype": "float32"}):
        j, t = jfg.FactorGridConfig(**kw), tfg.FactorGridConfig(**kw)
        assert (t.out_dim, t.resolutions) == (j.out_dim, j.resolutions)
    assert tfg.FactorGridConfig(**KW, **PLANES).out_dim == 3 * 4 + 3 * 2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cp_level_and_plane_features_match_jax(dtype):
    """The XLA functions alone: bf16 (or f32) hat matrices and products;
    one output rounding apart at most."""
    rng = np.random.default_rng(3)
    x = rng.random((300, 3)).astype(np.float32)
    x[: len(BOUNDARY)] = BOUNDARY
    lines = [(rng.standard_normal((13, 4)) * 0.5).astype(np.float32) for _ in range(3)]
    plane = (rng.standard_normal((9, 9, 3)) * 0.5).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    got = tfg.cp_level_features(torch.from_numpy(x), [torch.from_numpy(a) for a in lines], td)
    want = np.asarray(jfg.cp_level_features(jnp.asarray(x), tuple(jnp.asarray(a) for a in lines), jd), np.float32)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2**-8 * float(np.abs(want).max()))
    for axes in ((0, 1), (0, 2), (1, 2)):
        got = tfg.plane_features(torch.from_numpy(x), torch.from_numpy(plane), axes, td)
        want = np.asarray(jfg.plane_features(jnp.asarray(x), jnp.asarray(plane), axes, jd), np.float32)
        assert got.dtype == td and got.shape == (300, 3)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2**-8 * float(np.abs(want).max()))
    # a knot reads its plane row exactly (tests/test_factor_grid.py's check)
    exact = tfg.plane_features(torch.tensor([[0.25, 0.125, 0.0]]), torch.from_numpy(plane), (0, 1), torch.float32)
    np.testing.assert_allclose(exact[0].numpy(), plane[2, 1], rtol=1e-6)


@pytest.mark.parametrize("use_fused", [None, False], ids=["kernels", "xla"])
@pytest.mark.parametrize("planes", [False, True], ids=["lines", "planes"])
def test_module_forward_and_vjp_match_jax(planes, use_fused):
    """On the XLA path the port's expression is JAX's: features and every
    parameter's gradient within 2^-8 of max|ref| (the `_encode_reference`
    tolerance of tests/test_torch_factor_grid.py). On the kernels' path the
    CP levels take K3's and K4's f32 taps where JAX rounds to bf16: the
    features within 0.02 of max|ref| (the twin-against-XLA bound of
    tests/test_torch_factor_grid.py), the line grads per leaf by
    norm-relative error within 0.02 (as tests/test_torch_grad_encode.py
    holds K9's twin to the XLA VJP), the planes' as on the XLA path."""
    jcfg, enc, params, x, ct = case(planes)
    want, gp, gx = jax_module_vjp(jcfg, params, x, ct)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = enc(tx, use_fused=use_fused)
    assert got.shape == want.shape == (5, 7, jcfg.out_dim) and got.dtype == torch.float32
    tol = 2**-8 if use_fused is False else 0.02
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=tol * float(np.abs(want).max()))
    got.backward(torch.from_numpy(ct))
    for name, p in enc.named_parameters():
        if use_fused is False or name.startswith("plane_"):
            np.testing.assert_allclose(p.grad.numpy(), gp[name], rtol=0,
                                       atol=2**-8 * float(np.abs(gp[name]).max()), err_msg=name)
        else:
            assert rel(p.grad.numpy(), gp[name]) < 0.02, (name, rel(p.grad.numpy(), gp[name]))
    # the coordinates: the clip zeroes outside [0, 1]; at the knots the XLA
    # path's hat slopes and the kernels' rule (0 at a knot) differ
    inside = ((x > 0.0) & (x < 1.0)).all(-1)
    inside.reshape(-1)[: len(BOUNDARY)] = False
    assert rel(tx.grad.numpy()[inside], gx[inside]) < 0.02
    np.testing.assert_array_equal(tx.grad.numpy()[~((x >= 0.0) & (x <= 1.0))], 0.0)


def test_module_dispatch_on_the_cpu_is_the_plain_twin(monkeypatch):
    """On the CPU the CP levels go to K3's twin (and K4's in the backward),
    the planes to `plane_features`; the kernels' wrappers are never called."""
    calls = []
    for name in ("encode_plain", "encode_bwd_plain"):
        real = getattr(ffc, name)
        monkeypatch.setattr(ffc, name, lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k))
    for name in ("encode_cuda", "encode_bwd_cuda"):
        monkeypatch.setattr(ffc, name, lambda *a, **k: pytest.fail("a kernel was called on the CPU"))
    _, enc, _, x, ct = case(True)
    enc(torch.from_numpy(x)).backward(torch.from_numpy(ct))
    assert calls == ["encode_plain", "encode_bwd_plain"]
    calls.clear()
    enc(torch.from_numpy(x), use_fused=False)
    assert calls == []


def test_module_init_and_names():
    """flax's names and inits: lines N(0, 0.2), planes N(0, 0.02), [R_p, R_p, F_p]."""
    jcfg, enc, _, _, _ = case(True)
    jparams = jfg.FactorGridEncoding(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((2, 3)))["params"]
    assert sorted(dict(enc.named_parameters())) == sorted(jparams)
    for k, v in enc.state_dict().items():
        assert tuple(v.shape) == tuple(jparams[k].shape), k
    big = tfields.FactorGridEncoding(tfg.FactorGridConfig(**{**KW, **PLANES, "plane_res": 64, "plane_features": 8}))
    big.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(big.plane_01.detach().std()) - 0.02) < 0.002
    assert abs(float(big.line_2_0.detach().std()) - 0.2) < 0.1
    assert big.out_dim == 3 * 4 + 3 * 8


def jax_encode_with_grad_vjp(jcfg, params, x, ct_f, ct_d):
    enc = jfg.FactorGridEncoding(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    fn = lambda p: enc.apply({"params": p}, jnp.asarray(x), method=jfg.FactorGridEncoding.encode_with_grad)  # noqa: E731
    (f, d), vjp = jax.vjp(fn, jp)
    (gp,) = vjp((jnp.asarray(ct_f), jnp.asarray(ct_d)))
    return np.asarray(f), np.asarray(d), {k: np.asarray(v) for k, v in gp.items()}


@pytest.mark.parametrize("route", ["kernels", "xla"])
def test_encode_with_grad_matches_jax_vjp(route):
    """Values and the VJP w.r.t. the lines against `jax.vjp` of JAX's
    `encode_with_grad`. "xla" is the XLA expression itself,
    `cp_level_features_and_grad` over the levels: features and d features
    one output rounding apart, the line grads by autograd through the same
    bf16 products. "kernels" is the module's method (K3 + K8 forward,
    K4 + K9 backward, their twins here), which takes f32 taps and a slope
    of 0 at a knot: held per leaf by norm-relative error, as
    tests/test_torch_grad_encode.py holds K8 and K9's twins to the XLA
    expression."""
    jcfg, enc, params, x, ct = case(False)
    rng = np.random.default_rng(1)
    ct_d = rng.standard_normal((5, 7, 3, jcfg.out_dim)).astype(np.float32)
    f_j, d_j, g_j = jax_encode_with_grad_vjp(jcfg, params, x, ct, ct_d)
    if route == "xla":
        x01 = torch.from_numpy(x).reshape(-1, 3).clamp(0.0, 1.0)
        levels = [tfg.cp_level_features_and_grad(x01, axes) for axes in enc.get_lines()]
        f_t = torch.cat([f for f, _ in levels], -1).float().reshape(5, 7, -1)
        d_t = torch.cat([d for _, d in levels], -1).float().reshape(5, 7, 3, -1)
    else:
        f_t, d_t = enc.encode_with_grad(torch.from_numpy(x))
    assert f_t.shape == (5, 7, jcfg.out_dim) and d_t.shape == (5, 7, 3, jcfg.out_dim)
    np.testing.assert_allclose(f_t.detach().numpy(), f_j, rtol=0, atol=2**-8 * float(np.abs(f_j).max()))
    (f_t * torch.from_numpy(ct)).sum().add((d_t * torch.from_numpy(ct_d)).sum()).backward()
    if route == "xla":
        np.testing.assert_allclose(d_t.detach().numpy(), d_j, rtol=0, atol=2**-8 * float(np.abs(d_j).max()))
        for name, p in enc.named_parameters():
            # autograd through the same bf16 products, whose cotangents
            # round in another order than XLA's (measured up to 0.0052)
            assert rel(p.grad.numpy(), g_j[name]) < 0.02, (name, rel(p.grad.numpy(), g_j[name]))
    else:
        # off the knot rows (the XLA slope there is a hat's, the kernels' 0)
        n0 = len(BOUNDARY)
        assert rel(d_t.detach().reshape(-1, 3, jcfg.out_dim)[n0:], d_j.reshape(-1, 3, jcfg.out_dim)[n0:]) < 0.02
        for name, p in enc.named_parameters():
            assert rel(p.grad.numpy(), g_j[name]) < 0.05, (name, rel(p.grad.numpy(), g_j[name]))


def test_encode_with_grad_is_the_kernels_functions_and_refuses_planes():
    """The default path is `encode_fused` and `grad_encode_fused` bit for
    bit (K3 and K8 on the card); with planes it raises, as JAX asserts."""
    jcfg, enc, params, x, _ = case(False)
    tx = torch.from_numpy(x).reshape(-1, 3)
    f, d = enc.encode_with_grad(tx)
    lines = enc.get_lines()
    torch.testing.assert_close(f, tfg.encode_fused(enc.config, lines, tx), rtol=0, atol=0)
    torch.testing.assert_close(d, tfg.grad_encode_fused(enc.config, lines, tx), rtol=0, atol=0)
    _, penc, _, _, _ = case(True)
    with pytest.raises(ValueError, match="CP levels only"):
        penc.encode_with_grad(tx)


def test_normalize_aabb_matches_jax():
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(11, 3)).astype(np.float32)
    aabb = np.array([[-1.0, -2.0, -0.5], [1.0, 0.5, 2.0]], np.float32)
    got = tct.normalize_aabb(torch.from_numpy(pos), torch.from_numpy(aabb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jct.normalize_aabb(jnp.asarray(pos), jnp.asarray(aabb))))
