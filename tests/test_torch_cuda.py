"""The port's CUDA kernels on the card: K1 to K6 against their plain twins,
their input checks, one model chunk through K1, one train step through K1
and K2, and one `signerf` micro-batch and eval chunk through K1 to K6.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
module imports torch and the port only, so it also runs where JAX is not
installed; the repository's conftest imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import pytest
import torch

from signerf_tpu_torch.ops import factor_grid as fg
from signerf_tpu_torch.ops import fused_factor_cuda as ffc

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

SCHEDULES = {  # (levels, max_res, F, hidden, out)
    "proposal": (5, 128, 8, 16, 1),
    "prop256": (5, 256, 8, 16, 1),
    "final": (8, 2048, 16, 64, 16),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


def make_args(name, n, device, seed=0):
    levels, max_res, feat, hidden, out = SCHEDULES[name]
    g = torch.Generator().manual_seed(seed)
    cfg = fg.FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat)
    lines = [[torch.randn(r, feat, generator=g) * 0.2 for _ in range(3)] for r in cfg.resolutions]
    bf = torch.bfloat16
    ws = [
        torch.randn(cfg.out_dim, hidden, generator=g) * 0.1,
        torch.randn(hidden, generator=g) * 0.05,
        torch.randn(hidden, out, generator=g) * 0.1,
        torch.randn(out, generator=g) * 0.05,
    ]
    x = torch.rand(n, 3, generator=g)
    x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]])
    return [
        cfg.resolutions,
        feat,
        fg.pack_tables(lines).to(device),
        *[w.to(device, bf) for w in ws],
        x.to(device),
    ]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_kernel_matches_plain_twin(cuda, name):
    args = make_args(name, 100_003, cuda)
    before = ffc.launches
    got = ffc.density_mlp_cuda(*args)
    torch.cuda.synchronize()
    assert ffc.launches == before + 1
    want = ffc.density_mlp_plain(*args)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    # Same contract; FMA contraction and summation order can flip a bf16
    # rounding of a layer output: 2% of the output range at most.
    torch.testing.assert_close(got, want, rtol=0, atol=0.02 * float(want.abs().max()))


def test_kernel_refuses_what_it_does_not_take(cuda):
    args = make_args("proposal", 64, cuda)
    bad_dtype = list(args)
    bad_dtype[3] = args[3].float()
    with pytest.raises(TypeError):
        ffc.density_mlp_cuda(*bad_dtype)
    strided = list(args)
    strided[-1] = torch.rand(64, 6, device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ffc.density_mlp_cuda(*strided)
    grad = list(args)
    grad[-1] = args[-1].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ffc.density_mlp_cuda(*grad)
    other = list(args)
    other[1] = 4  # features_per_level without an instantiation
    with pytest.raises(ValueError, match="no kernel"):
        ffc.density_mlp_cuda(*other)


def test_model_chunk_launches_k1_three_times(cuda):
    from signerf_tpu_torch.cameras.cameras import RayBundle
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig

    model = NerfactoModel(NerfactoModelConfig(), num_train_images=4)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    g = torch.Generator().manual_seed(1)
    n = 1024
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    bundle = RayBundle(
        origins=(-2.0 * d).to(cuda),
        directions=d.to(cuda),
        pixel_area=torch.ones(n, 1, device=cuda),
        camera_indices=torch.zeros(n, 1, dtype=torch.int32, device=cuda),
        nears=torch.full((n, 1), 0.05, device=cuda),
        fars=torch.full((n, 1), 4.0, device=cuda),
    )
    before = ffc.launches
    with torch.inference_mode():
        out = model(bundle)
    torch.cuda.synchronize()
    assert ffc.launches == before + 3  # two proposal fields and the base field
    assert bool(torch.isfinite(out["rgb"]).all())
    acc = out["accumulation"]
    assert float(acc.min()) >= 0.0 and float(acc.max()) <= 1.0 + 1e-5


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-12))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_k2_matches_plain_twin(cuda, name):
    args = make_args(name, 100_003, cuda)
    res, feat, tables, w0, b0, w1, _, x = args
    g = torch.randn(x.shape[0], w1.shape[1], generator=torch.Generator().manual_seed(1)).to(cuda)
    bwd_args = (res, feat, tables, w0, b0, w1, x, g)
    t0, c0 = ffc.bwd_table_launches, ffc.bwd_coords_launches
    got = ffc.density_mlp_bwd_cuda(*bwd_args, tables_half=True, coords_half=True)
    torch.cuda.synchronize()
    assert (ffc.bwd_table_launches, ffc.bwd_coords_launches) == (t0 + 1, c0 + 1)
    want = ffc.density_mlp_bwd_plain(*bwd_args, tables_half=True, coords_half=True)
    leaves_got = [got[0], *got[1], got[2]]
    leaves_want = [want[0], *want[1], want[2]]
    for a, b in zip(leaves_got, leaves_want):
        assert a.dtype == torch.float32 and a.shape == b.shape and bool(torch.isfinite(a).all())
        # Same contract; the kernel's atomics and FMAs sum in another order
        # (f32): per-leaf norm-relative 1e-4 (measured under 2e-5).
        assert rel(a, b) < 1e-4
    only_tables = ffc.density_mlp_bwd_cuda(*bwd_args)
    assert only_tables[2] is None and ffc.bwd_coords_launches == c0 + 1


def test_k2_refuses_what_it_does_not_take(cuda):
    args = make_args("proposal", 64, cuda)
    res, feat, tables, w0, b0, w1, _, x = args
    g = torch.zeros(64, 1, device=cuda)
    with pytest.raises(TypeError):
        ffc.density_mlp_bwd_cuda(res, feat, tables, w0, b0, w1, x, g.double())
    with pytest.raises(ValueError, match="contiguous"):
        ffc.density_mlp_bwd_cuda(res, feat, tables, w0, b0, w1, x, torch.zeros(64, 2, device=cuda)[:, :1])
    with pytest.raises(RuntimeError, match="requires grad"):
        ffc.density_mlp_bwd_cuda(res, feat, tables, w0, b0, w1, x, g.requires_grad_(True))
    with pytest.raises(ValueError, match="no kernel"):
        ffc.density_mlp_bwd_cuda(res, 4, tables, w0, b0, w1, x, torch.zeros(64, 1, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        ffc.density_mlp_bwd_cuda(res, feat, tables.cpu(), w0.cpu(), b0.cpu(), w1.cpu(), x.cpu(), g.detach().cpu())


@pytest.mark.parametrize("camera_opt", [False, True])
def test_train_step_launches_k1_and_k2(cuda, camera_opt):
    """One full-width train step: K1 and K2's tables half three times (two
    proposal fields and the base field); K2's coords half only when camera
    opt makes the loss depend on the sample positions."""
    from signerf_tpu_torch.cameras.cameras import Cameras
    from signerf_tpu_torch.engine.optimizers import OptimizersConfig, make_optimizer
    from signerf_tpu_torch.engine.train_step import SamplerSettings, make_train_step
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig

    n_cams, hw = 2, 64
    model = NerfactoModel(NerfactoModelConfig(use_camera_opt=camera_opt), num_train_images=n_cams)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda)
    c2w = torch.eye(4)[:3].expand(n_cams, 3, 4).clone()
    c2w[:, 2, 3] = 2.0
    cams = Cameras(
        camera_to_worlds=c2w.to(cuda), fx=torch.full((n_cams,), 50.0, device=cuda),
        fy=torch.full((n_cams,), 50.0, device=cuda), cx=torch.full((n_cams,), hw / 2, device=cuda),
        cy=torch.full((n_cams,), hw / 2, device=cuda), width=hw, height=hw,
    )
    images = torch.randint(0, 256, (n_cams, hw, hw, 3), dtype=torch.uint8, device=cuda)
    opt = make_optimizer(OptimizersConfig(), model)
    step = make_train_step(model, opt, cams, SamplerSettings(num_rays=512))
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = (ffc.launches, ffc.bwd_table_launches, ffc.bwd_coords_launches)
    metrics = step(0, images, None, gen)
    torch.cuda.synchronize()
    after = (ffc.launches, ffc.bwd_table_launches, ffc.bwd_coords_launches)
    assert after[0] - before[0] == 3 and after[1] - before[1] == 3
    assert after[2] - before[2] == (3 if camera_opt else 0)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    with pytest.raises(ValueError, match="generator"):  # no sampling on the host for CUDA images
        step(1, images, None, torch.Generator().manual_seed(0))



def encode_args(n, device, seed=0):
    """Base-field tables (8 levels, F = 16), x01 with u in {0, 1} rows, g, ct."""
    g = torch.Generator().manual_seed(seed)
    cfg = fg.FactorGridConfig(num_levels=8, base_res=16, max_res=2048, features_per_level=16)
    lines = [[torch.randn(r, 16, generator=g) * 0.2 for _ in range(3)] for r in cfg.resolutions]
    x = torch.rand(n, 3, generator=g)
    x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]])
    grad = torch.randn(n, cfg.out_dim, generator=g)
    ct = torch.randn(n, 3, generator=g)
    args = (cfg.resolutions, 16, fg.pack_tables(lines).to(device), x.to(device))
    return args, grad.to(device), ct.to(device)


# N = 257 (boundary rows, a ragged last block), an N whose L * N items end
# mid-warp, and one signerf micro-batch's base-field samples.
ENCODE_NS = [257, 1003, 196_608]


@pytest.mark.parametrize("n", ENCODE_NS)
def test_k3_and_k5_match_plain_twins(cuda, n):
    args, g, _ = encode_args(n, cuda)
    c3, c5 = ffc.encode_launches, ffc.grad_dot_launches
    feat = ffc.encode_cuda(*args)
    s = ffc.grad_dot_cuda(*args, g)
    torch.cuda.synchronize()
    assert (ffc.encode_launches, ffc.grad_dot_launches) == (c3 + 1, c5 + 1)
    want_feat = ffc.encode_plain(*args)
    want_s = ffc.grad_dot_plain(*args, g)
    # The same f32 formulas; FMA contraction moves the last bits of each
    # lerp and product (chip_smoke.py's K3_TOL and K456_TOL).
    torch.testing.assert_close(feat, want_feat, rtol=0, atol=1e-5 * float(want_feat.abs().max()))
    assert rel(s, want_s) < 1e-4
    # exactly 0 on an axis at a knot of every level (u = 0 or 1)
    assert bool((s[:2] == 0).all()) and float(s[2, 1]) == 0.0 and float(s[3, 1]) == 0.0


@pytest.mark.parametrize("n", ENCODE_NS)
def test_k4_and_k6_match_plain_twins(cuda, n):
    args, g, ct = encode_args(n, cuda, seed=1)
    before = [getattr(ffc, c) for c in ffc.COUNTERS[4:6] + ffc.COUNTERS[7:9]]
    got4 = ffc.encode_bwd_cuda(*args, g, tables_half=True, coords_half=True)
    got6 = ffc.grad_dot_bwd_cuda(*args, g, ct, tables_half=True, coords_half=True)
    torch.cuda.synchronize()
    assert [getattr(ffc, c) for c in ffc.COUNTERS[4:6] + ffc.COUNTERS[7:9]] == [b + 1 for b in before]
    want4 = ffc.encode_bwd_plain(*args, g, True, True)
    want6 = ffc.grad_dot_bwd_plain(*args, g, ct, True, True)
    for a, b in zip(got4 + got6, want4 + want6):
        assert a.dtype == torch.float32 and a.shape == b.shape and bool(torch.isfinite(a).all())
        # f32 sums in another order (atomics in the tables halves): per-leaf
        # norm-relative 1e-4, as K2
        assert rel(a, b) < 1e-4
    only_tables = ffc.grad_dot_bwd_cuda(*args, g, ct)
    assert only_tables[2] is None and only_tables[1] is not None


def test_k3_to_k6_refuse_what_they_do_not_take(cuda):
    args, g, ct = encode_args(64, cuda)
    res, feat, tables, x = args
    with pytest.raises(ValueError, match="no kernel"):
        ffc.encode_cuda(res[:5], feat, tables[: 3 * sum(res[:5]) * feat], x)  # a proposal-sized schedule
    with pytest.raises(TypeError):
        ffc.grad_dot_cuda(*args, g.double())
    with pytest.raises(ValueError, match="contiguous"):
        ffc.encode_bwd_cuda(*args, torch.zeros(64, 256, device=cuda)[:, ::2])
    with pytest.raises(RuntimeError, match="requires grad"):
        ffc.grad_dot_bwd_cuda(*args, g, ct.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="CUDA"):
        ffc.encode_cuda(res, feat, tables.cpu(), x.cpu())


def test_signerf_micro_batch_and_eval_chunk_launch_k1_to_k6(cuda):
    """One `signerf` micro-batch at full width: the base field through K3
    and K5 (forward) and K4 and K6's tables halves (backward), the two
    proposal fields through K1 and K2; then an eval chunk under
    inference_mode: K3, K5 once, K1 twice, nothing else."""
    from signerf_tpu_torch.cameras.cameras import RayBundle
    from signerf_tpu_torch.engine.train_step import default_loss_fn
    from signerf_tpu_torch.method_configs import signerf_method
    from signerf_tpu_torch.models.signerf import SIGNeRFModel

    model = SIGNeRFModel(signerf_method().pipeline.model, num_train_images=2)
    model = model.reset_parameters(torch.Generator().manual_seed(0)).to(cuda)
    g = torch.Generator().manual_seed(1)
    n = 1024  # one 32x32 patch
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, -1.0]), dim=-1)
    bundle = RayBundle(
        origins=torch.tensor([0.0, 0.0, 2.0]).expand(n, 3).to(cuda), directions=d.to(cuda),
        pixel_area=torch.ones(n, 1, device=cuda), camera_indices=torch.zeros(n, 1, dtype=torch.int32, device=cuda),
        nears=None, fars=None,
    )
    for c in ffc.COUNTERS:
        setattr(ffc, c, 0)
    out = model(bundle, None, train=True, anneal=1.0)
    total, ld = default_loss_fn(model, out, {"image": torch.rand(n, 3, generator=g).to(cuda)})
    total.backward()
    torch.cuda.synchronize()
    got = {c: getattr(ffc, c) for c in ffc.COUNTERS}
    assert got == {"launches": 2, "bwd_table_launches": 2, "bwd_coords_launches": 0, "encode_launches": 1,
                   "encode_bwd_table_launches": 1, "encode_bwd_coords_launches": 0, "grad_dot_launches": 1,
                   "grad_dot_bwd_table_launches": 1, "grad_dot_bwd_coords_launches": 0}
    assert "lpips_loss" in ld and all(bool(torch.isfinite(v)) for v in ld.values())
    assert bool(torch.isfinite(out["normals_samples"]).all())
    assert float(model.field.encoding.line_7_0.grad.abs().max()) > 0
    for c in ffc.COUNTERS:
        setattr(ffc, c, 0)
    with torch.inference_mode():
        out = model.eval()(bundle)
    torch.cuda.synchronize()
    assert (ffc.launches, ffc.encode_launches, ffc.grad_dot_launches) == (2, 1, 1)
    assert ffc.bwd_table_launches == ffc.encode_bwd_table_launches == ffc.grad_dot_bwd_table_launches == 0
    assert bool(torch.isfinite(out["rgb"]).all())
