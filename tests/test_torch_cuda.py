"""The port's CUDA kernels on the card: K1 to K10 against their plain
twins, their input checks, one model chunk through K1, one train step
through K1 and K2, the tables halves of K2, K4, K6 and K9 at ray-ordered
and one-cell coordinates and their run-to-run spread, the coords halves of
K2, K4 (both schedules) and K6 at every layout and at ragged and knot
rows, K5 and the coords halves of K4 and K6 with their exact zeros at the
knots, K4's coords half equal to K5 bit for bit at the base field, K7 at every ragged tail
of its tiles on strided views, one `signerf` micro-batch and eval chunk
through K1 to K6, K8 and K9 against K5 and K6, the entry points of K8
to K10, K7 at the edit pass's shapes, one small dataset-generator pass
on the card, the web viewer's `/render` through K1, a linear proposal
field through K3 and K4, `FactorGridEncoding`'s planes and
`encode_with_grad` through K3, K4, K8 and K9, one data-parallel step at
two or more ranks (K1 and K2 on every rank), one tensor-parallel SDXL
block at two ranks (K7 on each rank's heads), the kernels built once by
ranks that start together, and the eval render's chunk graph
(`engine/chunk_graph.py`) against the eager chunks: bit for bit at both
backends and with normals, after in-place weight updates, captured anew
after a move or another chunk size, with the eager chunks' counts.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
module imports torch and the port only, so it also runs where JAX is not
installed; the repository's conftest imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import re

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


# K1 vs its twin, max abs error over max|ref|: the same bf16 features bit
# for bit, but the tensor cores' f32 sums run in another order than the
# twin's, which can flip a bf16 rounding of h or of the output
# (chip_smoke.py's KERNEL_TOL: measured worst 0.0066 plus a margin).
K1_TOL = 0.01


def assert_k1_close(got, want):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=K1_TOL * float(want.abs().max()))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_kernel_matches_plain_twin(cuda, name):
    args = make_args(name, 100_003, cuda)
    before = ffc.launches
    got = ffc.density_mlp_cuda(*args)
    torch.cuda.synchronize()
    assert ffc.launches == before + 1
    assert_k1_close(got, ffc.density_mlp_plain(*args))


@pytest.mark.parametrize("n", [0, 1, 300_007])
@pytest.mark.parametrize("name", ["proposal", "final"])
def test_kernel_ragged_tiles_and_no_samples(cuda, name, n):
    """300,007 samples are several 128-sample tiles for every persistent
    block, the last one ragged; one sample; none."""
    args = make_args(name, max(n, 4), cuda)
    args[-1] = args[-1][:n].contiguous()
    got = ffc.density_mlp_cuda(*args)
    torch.cuda.synchronize()
    assert got.shape == (n, args[5].shape[1])
    if n:
        assert_k1_close(got, ffc.density_mlp_plain(*args))


def selection_cases(levels, feat, hidden, out):
    """(sel0, sel1) pairs of 0/1 selection matrices: hidden unit j reads
    feature sel0[j], output o reads hidden unit sel1[o]; over the cases
    the outputs read every level (tests/test_torch_factor_grid.py holds the
    twin to the same identity on the CPU)."""
    d = levels * feat
    if out == 1:
        return [([lvl * feat + lvl % feat] * hidden, [lvl % hidden]) for lvl in range(levels)]
    return [([(2 * j + s) % d for j in range(hidden)], [(4 * o + q) % hidden for o in range(out)])
            for s, q in ((0, 0), (1, 3))]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_kernel_is_exact_under_selection_matrices(cuda, name):
    """W0 and W1 0/1 selection matrices, zero biases, positive tables: each
    sum of the MLP has one nonzero term, exact in any order, so K1's output
    is relu(bf16(feat)) at the selected features exactly. That pins K1's
    bf16 features, at every level, to the twin's (and K2's recompute) bit
    for bit."""
    levels, max_res, feat, hidden, out = SCHEDULES[name]
    g = torch.Generator().manual_seed(9)
    cfg = fg.FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat)
    lines = [[torch.randn(r, feat, generator=g).abs() * 0.2 + 0.01 for _ in range(3)] for r in cfg.resolutions]
    tables = fg.pack_tables(lines).to(cuda)
    x = torch.cat([torch.rand(50_000, 3, generator=g), ray_ordered_x01(256, K2_PER_RAY[name], 9)]).to(cuda)
    enc = ffc.encode_plain(cfg.resolutions, feat, tables, x).to(torch.bfloat16).float()
    bf = torch.bfloat16
    for sel0, sel1 in selection_cases(levels, feat, hidden, out):
        w0 = torch.zeros(levels * feat, hidden)
        w0[sel0, list(range(hidden))] = 1.0
        w1 = torch.zeros(hidden, out)
        w1[sel1, list(range(out))] = 1.0
        args = (cfg.resolutions, feat, tables, w0.to(cuda, bf), torch.zeros(hidden, device=cuda, dtype=bf),
                w1.to(cuda, bf), torch.zeros(out, device=cuda, dtype=bf), x)
        got = ffc.density_mlp_cuda(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, torch.relu(enc[:, [sel0[j] for j in sel1]]))
        assert torch.equal(got, ffc.density_mlp_plain(*args))


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
    misaligned = list(args)  # the weight copies take 16-byte pieces
    misaligned[3] = torch.empty(args[3].numel() + 1, device=cuda, dtype=args[3].dtype)[1:].view(args[3].shape)
    misaligned[3].copy_(args[3])
    with pytest.raises(ValueError, match="aligned"):
        ffc.density_mlp_cuda(*misaligned)


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


def ray_ordered_x01(rays, per_ray, seed):
    """Sample positions laid out as a train step lays them out: ray by ray,
    each ray's samples in order along it (cameras on a circle of radius 2
    looking at the origin, random pixels of a 512 px frame, stratified
    distances 0.05 to 1000, linear to 1 and then in disparity), contracted
    into the unit cube."""
    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.ops.contraction import contract_to_unit

    g = torch.Generator().manual_seed(seed)
    poses = circle_poses(8, radius=2.0, theta=70.0, phi=(0.0, 315.0))
    cam = torch.randint(0, 8, (rays,), generator=g)
    px = torch.rand(rays, 2, generator=g) * 512.0
    d = torch.stack([(px[:, 0] - 256) / 409.6, -(px[:, 1] - 256) / 409.6, -torch.ones(rays)], -1)
    d = torch.nn.functional.normalize(torch.einsum("rij,rj->ri", poses[cam, :3, :3], d), dim=-1)
    s = (torch.arange(per_ray) + torch.rand(rays, per_ray, generator=g)) / per_ray
    t = torch.where(s < 0.5, 0.05 + 0.95 * 2 * s, 1.0 / (1.0 - (2 * s - 1) * (1.0 - 1e-3)))
    return contract_to_unit(poses[cam, None, :3, 3] + d[:, None] * t[..., None]).reshape(-1, 3)


def one_cell_x01(n, resolutions, seed, width=1e-4):
    """n points inside one cell of every level: each level and axis adds
    every sample into the same two rows."""
    import math

    for k in range(1000):
        c = 0.3 + 1e-3 * k
        if all(math.floor(c * (r - 1)) == math.floor((c + width) * (r - 1)) and c * (r - 1) % 1 > 1e-3
               for r in resolutions):
            return c + width * torch.rand(n, 3, generator=torch.Generator().manual_seed(seed))
    raise AssertionError("no point lies inside one cell of every level")


K2_PER_RAY = {"proposal": 256, "prop256": 96, "final": 48}


def k2_layout_args(name, layout, device):
    res, feat, tables, w0, b0, w1, _, _ = make_args(name, 4, device)
    x = ray_ordered_x01(1024, K2_PER_RAY[name], 3) if layout == "ray-ordered" else one_cell_x01(100_003, res, 3)
    g = torch.randn(x.shape[0], w1.shape[1], generator=torch.Generator().manual_seed(4))
    return res, feat, tables, w0, b0, w1, x.to(device), g.to(device)


def f64_chunk_sum(twin, n, chunk=2048):
    """A plain twin's sums over samples in float64: `twin(part)` gives a list
    of tensors for the samples in slice `part`, run on chunks of `chunk`
    samples and added in float64."""
    total = None
    for s in range(0, n, chunk):
        part = [t.double() for t in twin(slice(s, s + chunk))]
        total = part if total is None else [a + b for a, b in zip(total, part)]
    return total


@pytest.mark.parametrize("layout", ["ray-ordered", "one cell"])
@pytest.mark.parametrize("name", ["proposal", "final"])
def test_k1_k3_and_k10_at_ray_ordered_and_one_cell_coordinates(cuda, name, layout):
    """K1, and the encode kernels on the same tile routine (K3 and K10 for
    both fields), where a warp's lanes meet on the same rows."""
    res, feat, tables, w0, b0, w1, b1, _ = make_args(name, 4, cuda)
    x = ray_ordered_x01(1024, K2_PER_RAY[name], 6) if layout == "ray-ordered" else one_cell_x01(100_003, res, 6)
    x = x.to(cuda)
    args = (res, feat, tables, w0, b0, w1, b1, x)
    got = ffc.density_mlp_cuda(*args)
    torch.cuda.synchronize()
    assert_k1_close(got, ffc.density_mlp_plain(*args))
    encoders = [(ffc.dense_encode_cuda, ffc.dense_encode_plain), (ffc.encode_cuda, ffc.encode_plain)]
    for kernel, plain in encoders:
        feats = kernel(res, feat, tables, x)
        torch.cuda.synchronize()
        want = plain(res, feat, tables, x)
        # chip_smoke.py's K3_TOL
        torch.testing.assert_close(feats, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("layout", ["ray-ordered", "one cell"])
@pytest.mark.parametrize("name", ["proposal", "final"])
def test_k2_tables_half_at_ray_ordered_and_one_cell_coordinates(cuda, name, layout):
    """The tables half where its warp-aggregated scatter matters: each ray's
    samples on consecutive lanes, and every sample on the same two rows of
    each level and axis. There N f32 atomics into one row stray on their
    own, the twin's index_add_ as much as the kernel's reductions, so the
    one-cell case is held against the twin's terms summed in float64."""
    args = k2_layout_args(name, layout, cuda)
    t0 = ffc.bwd_table_launches
    got = ffc.density_mlp_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert ffc.bwd_table_launches == t0 + 1
    res, feat, tables, w0, b0, w1, x, g = args

    def twin(p):
        lines, ws, _ = ffc.density_mlp_bwd_plain(res, feat, tables, w0, b0, w1, x[p], g[p])
        return [lines, *ws]

    want = twin(slice(None)) if layout == "ray-ordered" else f64_chunk_sum(twin, x.shape[0])
    for a, b in zip([got[0], *got[1]], want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert rel(a, b) < 1e-4  # f32 sums in another order, per leaf


@pytest.mark.parametrize("name", ["proposal", "final"])
def test_k2_run_to_run_spread_is_f32_rounding(cuda, name):
    """The same inputs twice: the vector reductions and the per-block
    flushes add in another order each run, so the results differ, but only
    by f32 rounding of the twin's scale."""
    args = k2_layout_args(name, "ray-ordered", cuda)
    first = ffc.density_mlp_bwd_cuda(*args)
    second = ffc.density_mlp_bwd_cuda(*args)
    torch.cuda.synchronize()
    want = ffc.density_mlp_bwd_plain(*args)
    for a, b, w in zip([first[0], *first[1]], [second[0], *second[1]], [want[0], *want[1]]):
        assert float((a - b).abs().max()) <= 1e-5 * float(w.abs().max())


# Where K2's coords half is held against its twin: uniform coordinates, each
# ray's samples in order, every sample in one cell, N = 257 with rows on the
# unit cube's faces (K2's knot rule: the slope of the cell K1 reads, not 0),
# and an N that ends mid-tile.
K2_COORDS_LAYOUTS = ["uniform", "ray-ordered", "one cell", "knots", "ragged"]


@pytest.mark.parametrize("layout", K2_COORDS_LAYOUTS)
@pytest.mark.parametrize("name", ["proposal", "final"])
def test_k2_coords_half_at_every_layout(cuda, name, layout):
    """K2's coords half alone, one launch, at both instantiations (the
    proposal fields' 5 levels of F = 8, the base field's 8 of F = 16)."""
    n = {"knots": 257, "ragged": 100_003}.get(layout, 65_536)
    res, feat, tables, w0, b0, w1, _, x = make_args(name, n, cuda, seed=11)
    if layout == "ray-ordered":
        x = ray_ordered_x01(1024, K2_PER_RAY[name], 12).to(cuda)
    elif layout == "one cell":
        x = one_cell_x01(n, res, 12).to(cuda)
    g = torch.randn(x.shape[0], w1.shape[1], generator=torch.Generator().manual_seed(13)).to(cuda)
    args = (res, feat, tables, w0, b0, w1, x, g)
    t0, c0 = ffc.bwd_table_launches, ffc.bwd_coords_launches
    lines, ws, got = ffc.density_mlp_bwd_cuda(*args, tables_half=False, coords_half=True)
    torch.cuda.synchronize()
    assert lines is None and ws is None
    assert (ffc.bwd_table_launches, ffc.bwd_coords_launches) == (t0, c0 + 1)
    want = ffc.density_mlp_bwd_plain(*args, tables_half=False, coords_half=True)[2]
    assert got.shape == want.shape == (x.shape[0], 3) and bool(torch.isfinite(got).all())
    # The same contract; the tensor cores' f32 sums (g_h, g_feat) flip a few
    # bf16 roundings against the twin's (chip_smoke.py's K2_TOL).
    assert rel(got, want) < 1e-4


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


def k46_layout_args(name, layout, device, seed=5):
    """Tables of `name`'s schedule, x01 at `layout` (the train step's samples
    a ray: 48 for the base field, 256 for the proposal), g and ct."""
    if name == "final":
        (res, feat, tables, _), _, _ = encode_args(4, device, seed)
    else:
        res, feat, tables, *_ = make_args(name, 4, device, seed)
    x = ray_ordered_x01(1024, K2_PER_RAY[name], seed) if layout == "ray-ordered" else one_cell_x01(100_003, res, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn(x.shape[0], len(res) * feat, generator=gen)
    ct = torch.randn(x.shape[0], 3, generator=gen)
    return (res, feat, tables, x.to(device)), g.to(device), ct.to(device)


@pytest.mark.parametrize("layout", ["ray-ordered", "one cell"])
@pytest.mark.parametrize("name", ["final", "proposal"])
def test_k4_and_k6_tables_halves_at_ray_ordered_and_one_cell_coordinates(cuda, name, layout):
    """The tables halves where their warp-aggregated scatter matters: each
    ray's samples on consecutive lanes, and every sample on the same two
    rows of each level and axis (there against the twin's terms summed in
    float64, since N f32 additions into one row stray on their own). K6 and
    grad_g on the base field; K4 also at the proposal schedule (K10's
    backward)."""
    args, g, ct = k46_layout_args(name, layout, cuda)
    t4, t6 = ffc.encode_bwd_table_launches, ffc.grad_dot_bwd_table_launches
    got = {"K4": ffc.encode_bwd_cuda(*args, g)[0]}
    if name == "final":
        got["K6"], got["grad_g"], _ = ffc.grad_dot_bwd_cuda(*args, g, ct)
    torch.cuda.synchronize()
    assert ffc.encode_bwd_table_launches == t4 + 1
    assert ffc.grad_dot_bwd_table_launches == t6 + (name == "final")
    if layout == "ray-ordered":
        want = {"K4": ffc.encode_bwd_plain(*args, g)[0]}
        if name == "final":
            want["K6"], want["grad_g"], _ = ffc.grad_dot_bwd_plain(*args, g, ct)
    else:
        res, feat, tables, x = args
        want = {"K4": f64_chunk_sum(lambda p: [ffc.encode_bwd_plain(res, feat, tables, x[p], g[p])[0]], len(x))[0]}
        if name == "final":
            want["K6"] = f64_chunk_sum(lambda p: [ffc.grad_dot_bwd_plain(res, feat, tables, x[p], g[p], ct[p])[0]],
                                       len(x))[0]
            want["grad_g"] = ffc.grad_dot_bwd_plain(*args, g, ct)[1]
    for leaf, a in got.items():
        assert a.shape == want[leaf].shape and bool(torch.isfinite(a).all())
        assert rel(a, want[leaf]) < 1e-4, leaf  # f32 sums in another order, per leaf


def test_k4_and_k6_run_to_run_spread_is_f32_rounding(cuda):
    """The same ray-ordered inputs twice: the vector reductions add in
    another order each run, so the line grads differ, but only by f32
    rounding of the twin's scale; grad_g is the same bit for bit."""
    args, g, ct = k46_layout_args("final", "ray-ordered", cuda)
    first4, second4 = ffc.encode_bwd_cuda(*args, g)[0], ffc.encode_bwd_cuda(*args, g)[0]
    first6, second6 = ffc.grad_dot_bwd_cuda(*args, g, ct)[:2], ffc.grad_dot_bwd_cuda(*args, g, ct)[:2]
    torch.cuda.synchronize()
    want4 = ffc.encode_bwd_plain(*args, g)[0]
    want6 = ffc.grad_dot_bwd_plain(*args, g, ct)[0]
    assert float((first4 - second4).abs().max()) <= 1e-5 * float(want4.abs().max())
    assert float((first6[0] - second6[0]).abs().max()) <= 1e-5 * float(want6.abs().max())
    assert torch.equal(first6[1], second6[1])


@pytest.mark.parametrize("layout", ["uniform", "ray-ordered", "one cell"])
def test_k5_at_three_layouts_with_exact_zeros_at_knots(cuda, layout):
    """K5 on its shared encode tile where a warp's lanes meet on the same
    rows (each ray's samples in order; every sample in one cell) and at
    uniform coordinates, with four rows on knots of every level."""
    args, g, _ = k46_layout_args("final", layout, cuda, seed=9) if layout != "uniform" else encode_args(
        100_003, cuda, seed=9)
    res, feat, tables, x = args
    x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]], device=cuda)
    c5 = ffc.grad_dot_launches
    s = ffc.grad_dot_cuda(*args, g)
    torch.cuda.synchronize()
    assert ffc.grad_dot_launches == c5 + 1
    want = ffc.grad_dot_plain(*args, g)
    assert s.shape == want.shape and bool(torch.isfinite(s).all())
    assert rel(s, want) < 1e-4  # f32 sums in another order (chip_smoke.py's K456_TOL)
    assert bool((s[:2] == 0).all()) and float(s[2, 1]) == 0.0 and float(s[3, 1]) == 0.0


@pytest.mark.parametrize("layout", ["uniform", "ray-ordered", "one cell", "257", "1003"])
def test_k6_coords_half_at_every_layout_with_exact_zeros_at_knots(cuda, layout):
    """K6's coords half alone on K5's tile, at three layouts of one signerf
    micro-batch's size and at N = 257 and 1003 (ragged tiles), with four
    rows on knots of every level: an axis there is exactly 0."""
    if layout in ("ray-ordered", "one cell"):
        args, g, ct = k46_layout_args("final", layout, cuda, seed=14)
    else:
        args, g, ct = encode_args(int(layout) if layout.isdigit() else 100_003, cuda, seed=14)
    x = args[3]
    x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]], device=cuda)
    t6, c6 = ffc.grad_dot_bwd_table_launches, ffc.grad_dot_bwd_coords_launches
    lines, g_g, got = ffc.grad_dot_bwd_cuda(*args, g, ct, tables_half=False, coords_half=True)
    torch.cuda.synchronize()
    assert lines is None and g_g is None
    assert (ffc.grad_dot_bwd_table_launches, ffc.grad_dot_bwd_coords_launches) == (t6, c6 + 1)
    want = ffc.grad_dot_bwd_plain(*args, g, ct, tables_half=False, coords_half=True)[2]
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert rel(got, want) < 1e-4  # f32 sums in another order (chip_smoke.py's K456_TOL)
    assert bool((got[:2] == 0).all())
    assert [float(got[2, 1]), float(got[2, 2]), float(got[3, 0]), float(got[3, 1])] == [0.0] * 4


def k4_coords_args(name, layout, device, seed=16):
    """Tables of `name`'s schedule ("final": the base field), x01 at
    `layout` ("257" and "100003": uniform with ragged last tiles) with four
    rows on knots of every level, and g."""
    if layout in ("ray-ordered", "one cell"):
        args, g, _ = k46_layout_args(name, layout, device, seed)
    elif name == "final":
        args, g, _ = encode_args(int(layout), device, seed)
    else:
        res, feat, tables, *_, x = make_args(name, int(layout), device, seed)
        args = (res, feat, tables, x)
        g = torch.randn(len(x), len(res) * feat, generator=torch.Generator().manual_seed(seed + 1)).to(device)
    args[3][:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0], [1.0, 0.0, 0.5]], device=device)
    return args, g


@pytest.mark.parametrize("layout", ["257", "100003", "ray-ordered", "one cell"])
@pytest.mark.parametrize("name", ["final", "proposal", "prop256"])
def test_k4_coords_half_at_both_schedules_with_exact_zeros_at_knots(cuda, name, layout):
    """K4's coords half alone on K5's tile loop (at the proposal schedule
    on tiles of 256 samples, a thread a sample; at max_res 256 its finest
    level's tables stay in device memory): uniform at N = 257 and 100,003
    (ragged last tiles), ray-ordered and in one cell, with four rows on
    knots of every level, where an axis is exactly 0."""
    args, g = k4_coords_args(name, layout, cuda)
    t4, c4 = ffc.encode_bwd_table_launches, ffc.encode_bwd_coords_launches
    lines, got = ffc.encode_bwd_cuda(*args, g, tables_half=False, coords_half=True)
    torch.cuda.synchronize()
    assert lines is None
    assert (ffc.encode_bwd_table_launches, ffc.encode_bwd_coords_launches) == (t4, c4 + 1)
    want = ffc.encode_bwd_plain(*args, g, tables_half=False, coords_half=True)[1]
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert rel(got, want) < 1e-4  # f32 sums in another order (chip_smoke.py's K456_TOL)
    assert bool((got[:2] == 0).all())
    assert [float(got[2, 1]), float(got[2, 2]), float(got[3, 0]), float(got[3, 1])] == [0.0] * 4


@pytest.mark.parametrize("layout", ["100003", "ray-ordered", "one cell"])
def test_k4_coords_half_is_k5_bit_for_bit_at_the_base_field(cuda, layout):
    """At the base field K4's coords half is a launch of K5's own
    instantiation of the tile loop on the same g, in the same grid: the
    same sums in the same order."""
    args, g = k4_coords_args("final", layout, cuda, seed=17)
    got = ffc.encode_bwd_cuda(*args, g, tables_half=False, coords_half=True)[1]
    s = ffc.grad_dot_cuda(*args, g)
    torch.cuda.synchronize()
    assert torch.equal(got, s)


def k9_layout_args(layout, device, seed=7):
    """Base-field tables, x01 at `layout` and a cotangent ct [N, 3, L F]."""
    args, _, _ = k46_layout_args("final", layout, device, seed)
    ct = torch.randn(args[3].shape[0], 3, 128, generator=torch.Generator().manual_seed(seed + 2))
    return args, ct.to(device)


@pytest.mark.parametrize("layout", ["ray-ordered", "one cell"])
def test_k9_tables_half_at_ray_ordered_and_one_cell_coordinates(cuda, layout):
    """K9's tables half where its warp-aggregated scatter matters, as the
    tables halves of K4 and K6: in one cell against the twin's terms summed
    in float64, since N f32 additions into one row stray on their own."""
    args, ct = k9_layout_args(layout, cuda)
    t9 = ffc.grad_bwd_table_launches
    got = ffc.grad_bwd_cuda(*args, ct)[0]
    torch.cuda.synchronize()
    assert ffc.grad_bwd_table_launches == t9 + 1
    res, feat, tables, x = args
    if layout == "ray-ordered":
        want = ffc.grad_bwd_plain(*args, ct)[0]
    else:
        want = f64_chunk_sum(lambda p: [ffc.grad_bwd_plain(res, feat, tables, x[p], ct[p])[0]], len(x))[0]
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert rel(got, want) < 1e-4  # f32 sums in another order


def test_k9_run_to_run_spread_is_f32_rounding(cuda):
    """The same ray-ordered inputs twice: K9's L2 vector reductions add in
    another order each run, so the line grads differ, but only by f32
    rounding of the twin's scale."""
    args, ct = k9_layout_args("ray-ordered", cuda)
    first, second = ffc.grad_bwd_cuda(*args, ct)[0], ffc.grad_bwd_cuda(*args, ct)[0]
    torch.cuda.synchronize()
    want = ffc.grad_bwd_plain(*args, ct)[0]
    assert float((first - second).abs().max()) <= 1e-5 * float(want.abs().max())


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
                   "grad_dot_bwd_table_launches": 1, "grad_dot_bwd_coords_launches": 0, "grad_launches": 0,
                   "grad_bwd_table_launches": 0, "grad_bwd_coords_launches": 0, "dense_encode_launches": 0}
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


# ---------------------------------------------------------------------------
# K8 to K10


@pytest.mark.parametrize("n", ENCODE_NS)
def test_k8_and_k9_match_twins_and_k5_k6(cuda, n):
    args, g, c = encode_args(n, cuda, seed=2)
    ct = torch.randn(n, 3, g.shape[1], generator=torch.Generator().manual_seed(3)).to(cuda)
    before = (ffc.grad_launches, ffc.grad_bwd_table_launches, ffc.grad_bwd_coords_launches)
    out = ffc.grad_cuda(*args)
    got9 = ffc.grad_bwd_cuda(*args, ct, tables_half=True, coords_half=True)
    torch.cuda.synchronize()
    assert (ffc.grad_launches, ffc.grad_bwd_table_launches, ffc.grad_bwd_coords_launches) == tuple(
        b + 1 for b in before)
    want = ffc.grad_plain(*args)
    assert out.shape == (n, 3, g.shape[1]) and bool(torch.isfinite(out).all())
    # The same f32 formulas; FMA contraction and the atomics' order move the
    # last bits (chip_smoke.py's K456_TOL)
    assert rel(out, want) < 1e-4
    assert bool((out[:2] == 0).all()) and bool((out[2:4, 1] == 0).all())  # exact zeros at the knots
    for a, b in zip(got9, ffc.grad_bwd_plain(*args, ct, True, True)):
        assert a.dtype == torch.float32 and a.shape == b.shape and rel(a, b) < 1e-4
    # K8 contracted with g is K5; K9 on ct = g (x) c is K6 for the scalar c.
    assert rel(torch.einsum("nad,nd->na", out, g), ffc.grad_dot_cuda(*args, g)) < 1e-4
    g9, c9 = ffc.grad_bwd_cuda(*args, g[:, None, :] * c[:, :, None], True, True)
    g6, _, c6 = ffc.grad_dot_bwd_cuda(*args, g, c, True, True)
    assert rel(g9, g6) < 1e-4 and rel(c9, c6) < 1e-4


@pytest.mark.parametrize("name", ["proposal", "final"])
@pytest.mark.parametrize("n", [257, 100_003])
def test_k10_and_its_backward_match_twins(cuda, name, n):
    from signerf_tpu_torch.ops.factor_grid_kernel import factor_encode_kernel

    res, feat, tables, *_, x = make_args(name, n, cuda, seed=4)
    before = ffc.dense_encode_launches
    got = ffc.dense_encode_cuda(res, feat, tables, x)
    torch.cuda.synchronize()
    assert ffc.dense_encode_launches == before + 1
    want = ffc.dense_encode_plain(res, feat, tables, x)
    assert got.shape == (n, len(res) * feat) and bool(torch.isfinite(got).all())
    # the same contract: exact products, one rounding of their sum (K3_TOL)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    if name == "final":  # K3 keeps f32 tap weights: within their bf16 rounding
        k3 = ffc.encode_cuda(res, feat, tables, x)
        torch.testing.assert_close(got, k3, rtol=0, atol=0.01 * float(k3.abs().max()))
    # The entry point's backward runs K4's two launches (proposal: K4's
    # 5-level instantiations, its coords half on the tile loop's 256-sample
    # tiles), against K4's twin on the CPU.
    lines = [t.float() for t in torch.split(tables, [r * feat for r in res for _ in range(3)])]
    lines = [t.view(-1, feat) for t in lines]
    gout = torch.randn(n, len(res) * feat, generator=torch.Generator().manual_seed(5))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        ls = [t.detach().to(dev).requires_grad_(True) for t in lines]
        xx = x.detach().to(dev).requires_grad_(True)
        t0, c0 = ffc.encode_bwd_table_launches, ffc.encode_bwd_coords_launches
        (factor_encode_kernel(xx, ls, res) * gout.to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (ffc.encode_bwd_table_launches, ffc.encode_bwd_coords_launches) == (t0 + 1, c0 + 1)
        grads.append([xx.grad.cpu()] + [t.grad.cpu() for t in ls])
    for a, b in zip(*grads):
        assert rel(a, b) < 1e-4


def test_k8_to_k10_refuse_what_they_do_not_take(cuda):
    args, g, _ = encode_args(64, cuda)
    res, feat, tables, x = args
    with pytest.raises(ValueError, match="no kernel"):
        ffc.grad_cuda(res[:5], 8, tables[: 3 * sum(res[:5]) * 8], x)  # a proposal-sized schedule
    with pytest.raises(ValueError, match="no kernel"):
        ffc.dense_encode_cuda(res[:4], feat, tables[: 3 * sum(res[:4]) * feat], x)
    with pytest.raises(ValueError):
        ffc.grad_bwd_cuda(*args, g)  # a [N, D] cotangent where K9 takes [N, 3, D]
    with pytest.raises(TypeError):
        ffc.grad_bwd_cuda(*args, torch.zeros(64, 3, g.shape[1], device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        ffc.dense_encode_cuda(res, feat, tables.cpu(), x.cpu())


def test_grad_entry_points_launch_k8_and_k9(cuda):
    """`grad_encode_fused` runs K8 forward and K9 backward (the coords half
    only for an x01 that needs a grad); `fused_factor_grad` runs K8 and no
    backward kernel."""
    args, _, _ = encode_args(1003, cuda, seed=6)
    res, feat, tables, x = args
    cfg = fg.FactorGridConfig(num_levels=8, base_res=16, max_res=2048, features_per_level=16)
    lines = [t.float().view(-1, feat).requires_grad_(True)
             for t in torch.split(tables, [r * feat for r in res for _ in range(3)])]
    nested = [lines[3 * i : 3 * i + 3] for i in range(len(res))]
    ct = torch.randn(1003, 3, 128, device=cuda)
    for c in ffc.COUNTERS:
        setattr(ffc, c, 0)
    xx = x.clone().requires_grad_(True)
    (fg.grad_encode_fused(cfg, nested, xx) * ct).sum().backward()
    (fg.fused_factor_grad(cfg, nested, x) * ct).sum().backward()
    torch.cuda.synchronize()
    got = {c: getattr(ffc, c) for c in ffc.COUNTERS if getattr(ffc, c)}
    assert got == {"grad_launches": 2, "grad_bwd_table_launches": 1, "grad_bwd_coords_launches": 1}
    assert float(xx.grad.abs().max()) > 0 and all(bool(torch.isfinite(t.grad).all()) for t in lines)


# ---------------------------------------------------------------------------
# K7: flash self-attention


def _qkv(b, s, h, device, seed=0, d=64):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g).to(device, torch.bfloat16) for _ in range(3)]


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


# K7 keeps the scores in f32 where the twin rounds them to bf16 (and scales
# in bf16): the two differ by that rounding, 1e-2 of the norm; against an
# f32 reference (q, k, v upcast) K7 is within 5e-3 and the closer of the two.
@pytest.mark.parametrize("b,s,h", [(1, 1, 1), (3, 77, 2), (1, 130, 10), (2, 257, 3), (1, 1000, 10), (2, 2304, 20)])
def test_k7_matches_twin_and_f32_reference(cuda, b, s, h):
    from signerf_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(b, s, h, cuda, seed=s)
    got = fa.flash_attention_cuda(q, k, v, 0.125)
    torch.cuda.synchronize()
    twin = fa.flash_attention_plain(q, k, v, 0.125)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    ref = (torch.softmax(qf @ kf.transpose(-1, -2) * 0.125, -1) @ vf).transpose(1, 2).reshape(b, s, h * 64)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, s, h * 64)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, twin) < 1e-2
    assert _rel(got, ref) < 5e-3
    assert _rel(got, ref) <= _rel(twin, ref)


def test_k7_reads_strided_inputs(cuda):
    """q, k and v as views of one [B, S, 3, H, 64] projection (no copies)."""
    from signerf_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 300, 3, 4, 64, generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = fa.flash_attention_cuda(q, k, v, 0.125)
    want = fa.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), 0.125)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 2304, 9217])
def test_k7_ragged_lengths_on_a_strided_projection(cuda, s):
    """Every ragged tail of K7's tiles (128 keys, 192 queries as three
    blocks of 64 rows), at B = 2, with q, k and v as
    strided views of one [B, S, 3, H, 64] projection: against the twin and
    an f32 reference, and equal to K7 on contiguous copies."""
    from signerf_tpu_torch.ops import flash_attention as fa

    b, h = 2, 2 if s > 4096 else 3
    g = torch.Generator().manual_seed(s)
    q, k, v = torch.randn(b, s, 3, h, 64, generator=g).to(cuda, torch.bfloat16).unbind(2)
    got = fa.flash_attention_cuda(q, k, v, 0.125)
    dense = fa.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), 0.125)
    torch.cuda.synchronize()
    twin = fa.flash_attention_plain(q, k, v, 0.125)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    ref = (torch.softmax(qf @ kf.transpose(-1, -2) * 0.125, -1) @ vf).transpose(1, 2).reshape(b, s, h * 64)
    assert torch.equal(got, dense)
    assert _rel(got, twin) < 1e-2
    assert _rel(got, ref) < 5e-3
    assert _rel(got, ref) <= _rel(twin, ref)


def test_k7_refuses_misaligned_views(cuda):
    """TMA reads from 16-byte aligned bases with strides of whole 16-byte
    units: a view off by 8 bytes, or with 68-value rows, is refused."""
    from signerf_tpu_torch.ops import flash_attention as fa

    _, k, v = _qkv(1, 16, 2, cuda)
    shifted = torch.zeros(1, 16, 2, 72, device=cuda, dtype=torch.bfloat16)[..., 4:68]
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(shifted, k, v, 0.125)
    odd = torch.zeros(1, 16, 2, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(odd, k, v, 0.125)


def test_k7_refuses_what_it_does_not_take(cuda):
    from signerf_tpu_torch.ops import flash_attention as fa

    q, k, v = _qkv(1, 16, 2, cuda)
    with pytest.raises(ValueError, match="64"):
        fa.flash_attention_cuda(*(t[..., :32] for t in (q, k, v)), 0.125)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.float(), k.float(), v.float(), 0.125)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k[:, :8], v, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(torch.zeros(1, 16, 2, 128, device=cuda, dtype=torch.bfloat16)[..., ::2], k, v, 0.125)


def test_k7_launch_counter_and_cross_attention_route(cuda):
    """A CUDA self-attention at head dim 64 launches K7 once; the switch
    off, and cross-attention, take the twin."""
    from signerf_tpu_torch.diffusion import unet as unet_mod
    from signerf_tpu_torch.ops import flash_attention as fa

    attn = unet_mod.CrossAttention(128, 128, 2, 64)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        attn = attn.to(cuda)
        x = torch.randn(2, 100, 128, generator=gen).to(cuda, torch.bfloat16)
        fa.launches = 0
        out = attn(x)
        torch.cuda.synchronize()
        assert fa.launches == 1
        attn(x, torch.randn(2, 7, 128, generator=gen).to(cuda, torch.bfloat16))
        unet_mod.set_flash_attention(False)
        try:
            twin = attn(x)
        finally:
            unet_mod.set_flash_attention(True)
        assert fa.launches == 1
    assert _rel(out, twin) < 1e-2


@pytest.mark.parametrize("b,s,h", [(2, 1536, 10), (2, 384, 20), (8, 1536, 10), (8, 384, 20)])
def test_k7_at_the_edit_pass_shapes(cuda, b, s, h):
    """The self-attention of the default 2x3 sheet of 256 px cells (512 x
    768, latent 64 x 96): the sheet call at B = 2 (CFG), a chunk of 4
    views at B = 8; the bounds of test_k7_matches_twin_and_f32_reference."""
    test_k7_matches_twin_and_f32_reference(cuda, b, s, h)


# ---------------------------------------------------------------------------
# The dataset generator on the card


def test_generator_pass_runs_on_the_card(cuda, tmp_path):
    """A 2 x 2 sheet of 32 px cells through the tiny in-process SDXL on the
    card: the cameras, renders, masks, sheets and the diffusion stay on the
    card, and the dataset is written."""
    import json
    import warnings

    import numpy as np

    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.diffusion import sdxl_pipeline as sp
    from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
    from signerf_tpu_torch.generator.datasetgenerator import DatasetGenerator, DatasetGeneratorConfig

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = sp.SDXLInpaintPipeline.create(config=sp.TINY_SDXL_CONFIG, device=cuda)
    devices = []

    def render(cameras, index):
        rb = cameras.generate_rays(camera_index=index)
        o, d = rb.origins, rb.directions
        b = (o * d).sum(-1)
        disc = b * b - ((o * o).sum(-1) - 0.25)
        t = -b - torch.sqrt(disc.clamp_min(0.0))
        hit = disc > 0
        rgb = torch.where(hit[..., None], (o + d * t[..., None]).abs().clamp(0, 1), torch.ones_like(o))
        devices.append(rb.origins.device.type)
        return {"rgb": rgb, "depth": torch.where(hit, t, torch.full_like(t, 3.0))[..., None]}

    cfg = DatasetGeneratorConfig(path=tmp_path, fx=60.0, fy=60.0, cx=32.0, cy=32.0, width=64, height=64, rows=2,
                                 cols=2, aabb_min=(-0.5, -0.5, -0.5), aabb_max=(0.5, 0.5, 0.5), mask_dilation=(5, 5),
                                 diffuser=DiffuserConfig(num_inference_steps=3))
    gen = DatasetGenerator(cfg, np.eye(4)[:3], 1.0, lambda p: p, render, diffuser=Diffuser(cfg.diffuser, pipeline=pipe))
    assert gen.device.type == "cuda"
    ref = circle_poses(3, radius=2.0, theta=60.0, phi=(0.0, 240.0)).numpy()
    syn = circle_poses(2, radius=2.0, theta=75.0, phi=(0.0, 180.0)).numpy()
    sheet = gen.generate_reference_sheet(gen._cameras_from_poses(ref))
    assert all(t.device.type == "cuda" for t in sheet[:4])
    assert all(v.device.type == "cuda" for r in sheet[4] for v in r.values())
    out = gen.generate_dataset(reference_camera_to_worlds=ref, synthetic_camera_to_worlds=syn)
    assert set(devices) == {"cuda"}
    meta = json.loads((out / "transforms.json").read_text())
    assert meta["reference_indices"] == [0, 1, 2] and meta["generated_indices"] == [3, 4]
    assert len(list((out / "images").glob("*.png"))) == 5 and len(list((out / "images_2").glob("*.png"))) == 5


# ---------------------------------------------------------------------------
# The viewer on the card


def test_viewer_render_launches_k1_per_chunk(cuda, tmp_path):
    """The web viewer over a `signerf_nerfacto` trainer at its defaults on
    the card: `/render` at 128 px is 16,384 rays, two 8192-ray chunks, so
    exactly 3 x 2 K1 launches, and a PNG of 128 x 128."""
    import json
    import urllib.request

    import numpy as np

    from signerf_tpu_torch.cameras.poses import circle_poses
    from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
    from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer
    from signerf_tpu_torch.interface import GenerationInterface
    from signerf_tpu_torch.interface.app import ViewerServer
    from signerf_tpu_torch.method_configs import signerf_nerfacto_method
    from signerf_tpu_torch.utils.images import decode_png, save_array_png

    (tmp_path / "images").mkdir()
    frames = []
    for i, pose in enumerate(circle_poses(4, radius=2.0, theta=70.0, phi=(0.0, 270.0)).numpy()):
        save_array_png(np.full((32, 32, 3), 0.25 * i), tmp_path / "images" / f"frame_{i}.png")
        frames.append({"file_path": f"images/frame_{i}.png", "transform_matrix": pose.tolist()})
    meta = {"fl_x": 40.0, "fl_y": 40.0, "cx": 16.0, "cy": 16.0, "w": 32, "h": 32, "frames": frames}
    (tmp_path / "transforms.json").write_text(json.dumps(meta))
    cfg = signerf_nerfacto_method()
    cfg.output_dir = tmp_path / "out"
    cfg.pipeline.datamanager.dataparser.data = tmp_path
    trainer = SIGNeRFTrainer(cfg, cuda)
    trainer.setup(diffuser=Diffuser(DiffuserConfig(mode="custom"), custom_fn=lambda image, *a, **kw: image))
    httpd = ViewerServer(GenerationInterface(trainer), port=0).start_background()
    try:
        for name in ffc.COUNTERS:
            setattr(ffc, name, 0)
        url = f"http://127.0.0.1:{httpd.server_address[1]}/render?yaw=30&pitch=60&radius=2.0&size=128"
        with urllib.request.urlopen(url, timeout=300) as r:
            body = r.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert ffc.launches == 6 and all(getattr(ffc, name) == 0 for name in ffc.COUNTERS[1:])
    img = decode_png(body)
    assert img.shape == (128, 128, 3)


def _zero_counts():
    for name in ffc.COUNTERS:
        setattr(ffc, name, 0)


def _launched():
    return {name: getattr(ffc, name) for name in ffc.COUNTERS if getattr(ffc, name)}


@pytest.mark.parametrize("name", ["proposal", "prop256"])
def test_linear_proposal_field_takes_k3_and_k4(cuda, name):
    """A linear proposal field on the card: its features through K3 (and
    K4's tables half backward), never K1; its density and line grads equal
    the same field on the CPU's twins within K3's and K4's gates."""
    from signerf_tpu_torch.models.fields import HashMLPDensityField

    _, max_res, _, _, _ = SCHEDULES[name]
    field = HashMLPDensityField(max_res=max_res, use_linear=True)
    field.reset_parameters(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    pos = (torch.rand(2048, 3, generator=g) * 4.0 - 2.0).reshape(64, 32, 3)
    cpu = field(pos)
    cpu.sum().backward()
    want = {k: p.grad.clone() for k, p in field.named_parameters()}
    field = field.to(cuda)
    field.zero_grad()
    _zero_counts()
    got = field(pos.to(cuda))
    got.sum().backward()
    torch.cuda.synchronize()
    assert _launched() == {"encode_launches": 1, "encode_bwd_table_launches": 1}
    torch.testing.assert_close(got.detach().cpu(), cpu.detach(), rtol=2e-2, atol=1e-5 * float(cpu.detach().abs().max()))
    for k, p in field.named_parameters():
        err = float((p.grad.cpu() - want[k]).norm() / want[k].norm().clamp_min(1e-12))
        assert err < 1e-4 if k.startswith("FactorGridEncoding") else err < 2e-2, (k, err)


def test_factor_encoding_planes_and_encode_with_grad_on_the_card(cuda):
    """`FactorGridEncoding` with planes (K3, K4 for the CP levels) and
    `encode_with_grad` (K3, K8; K4, K9 backward) against the same module
    on the CPU's twins."""
    from signerf_tpu_torch.models.fields import FactorGridEncoding

    levels, max_res, feat, _, _ = SCHEDULES["final"]
    g = torch.Generator().manual_seed(5)
    x = torch.rand(4096, 3, generator=g)
    for planes in (True, False):
        cfg = fg.FactorGridConfig(num_levels=levels, base_res=16, max_res=max_res, features_per_level=feat,
                                  include_planes=planes, plane_res=32)
        enc = FactorGridEncoding(cfg)
        enc.reset_parameters(torch.Generator().manual_seed(6))
        ct = torch.randn(4096, cfg.out_dim, generator=g)
        ct_d = torch.randn(4096, 3, cfg.out_dim, generator=g)

        def run(e, dev):
            e.zero_grad()
            if planes:
                out = e(x.to(dev))
                (out * ct.to(dev)).sum().backward()
                outs = (out,)
            else:
                f, d = e.encode_with_grad(x.to(dev))
                ((f * ct.to(dev)).sum() + (d * ct_d.to(dev)).sum()).backward()
                outs = (f, d)
            return [o.detach().cpu() for o in outs], {k: p.grad.cpu().clone() for k, p in e.named_parameters()}

        want, g_want = run(enc, torch.device("cpu"))
        enc = enc.to(cuda)
        _zero_counts()
        got, g_got = run(enc, cuda)
        torch.cuda.synchronize()
        expected = ({"encode_launches": 1, "encode_bwd_table_launches": 1} if planes else
                    {"encode_launches": 1, "encode_bwd_table_launches": 1, "grad_launches": 1,
                     "grad_bwd_table_launches": 1})
        assert _launched() == expected
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=2**-8 * float(want[0].abs().max()))
        for a, b in zip(got[1:], want[1:]):
            assert float((a - b).norm() / b.norm()) < 1e-4
        for k in g_want:
            assert float((g_got[k] - g_want[k]).norm() / g_want[k].norm().clamp_min(1e-12)) < 1e-4, k


def test_microbench_times_a_known_sleep(cuda):
    """`utils/microbench`'s CUDA-event timer and profiler breakdown against a
    kernel of known length: `torch.cuda._sleep` spins for a number of clock
    cycles, whose length one host clock around a synchronised launch
    measures (its ~10 us launch is noise at ~30 ms)."""
    import time

    from signerf_tpu_torch.utils import microbench as mb

    cycles = 50_000_000
    torch.cuda._sleep(cycles)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    length_ms = (time.perf_counter() - t0) * 1e3
    timing = mb.cuda_time_stats(lambda: torch.cuda._sleep(cycles), iters=3, repeats=3)
    assert timing.resolved and abs(timing.median_ms - length_ms) <= 0.2 * length_ms, (timing, length_ms)
    assert abs(mb.cuda_ms(lambda: torch.cuda._sleep(cycles), 3) - length_ms) <= 0.2 * length_ms
    bd = mb.kernel_breakdown(lambda: torch.cuda._sleep(cycles), [("sleep", ("sleep", "spin"))], iters=2)
    assert abs(bd["busy_ms"] - length_ms) <= 0.2 * length_ms and bd["idle_share"] < 0.2, bd


def test_spans_time_the_stream_and_put_no_range_on_the_card(cuda):
    """`utils/tracing`: a stream span's events time the stream between its
    ends (a known sleep); a span is a host range of the trace and puts no
    range of its own on the card's timeline, which a trace would count as
    device time; a span on autograd's backward thread records (the
    profiler's flag is on there) and starts a unit of its own."""
    import threading
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from signerf_tpu_torch.utils import tracing

    cycles = 50_000_000
    torch.cuda._sleep(cycles)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    length_ms = (time.perf_counter() - t0) * 1e3
    seen = {}

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen["thread"] = threading.get_ident()
            with tracing.span("backward.inside"):
                return g * 2

    x = torch.ones(1024, device="cuda", requires_grad=True)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.span("step"):
            with tracing.span("sleep", stream=True):
                torch.cuda._sleep(cycles)
            Twice.apply(x).sum().backward()
        torch.cuda.synchronize()
    records = {r.name: r for r in tracing._records}
    s = tracing.summary()
    tracing.reset()
    assert abs(s["spans"]["sleep"]["stream_ms"] - length_ms) <= 0.2 * length_ms, (s, length_ms)
    assert s["spans"]["step"]["stream_ms"] is None and s["units"] == 2
    host = {e.name for e in prof.events() if e.device_type != DeviceType.CUDA}
    card = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    assert {"step", "sleep", "backward.inside"} <= host and not card & {"step", "sleep", "backward.inside"}
    assert seen["thread"] != threading.get_ident()
    assert records["backward.inside"].unit == records["backward.inside"].id and records["backward.inside"].parent is None


def test_kernel_breakdown_gives_a_span_its_kernels_not_its_idle_stream(cuda):
    """`microbench.kernel_breakdown`'s `device_ms` a span: the kernels
    launched inside it, on the step's thread and on autograd's backward
    thread; its CUDA events' `stream_ms` also holds the stream's wait for
    the host (a host sleep inside the span)."""
    import time

    from signerf_tpu_torch.utils import tracing
    from signerf_tpu_torch.utils.microbench import kernel_breakdown

    a = torch.randn(2048, 2048, device="cuda", requires_grad=True)

    def step():
        with tracing.span("step"):
            with tracing.span("work", stream=True):
                y = (a @ a).square().sum()
                time.sleep(0.05)
            with tracing.span("backward", stream=True):
                y.backward()
            with tracing.span("idle", stream=True):
                time.sleep(0.01)
        a.grad = None

    bd = kernel_breakdown(step, [], iters=2)
    sp = bd["spans"]
    assert sp["step"]["device_ms"] == pytest.approx(bd["busy_ms"], rel=1e-6), bd
    assert sp["work"]["device_ms"] + sp["backward"]["device_ms"] == pytest.approx(bd["busy_ms"], rel=1e-6), bd
    assert sp["idle"]["device_ms"] == 0 and sp["backward"]["device_ms"] > sp["work"]["device_ms"] > 0, bd
    assert sp["work"]["stream_ms"] >= 45 > 10 * sp["work"]["device_ms"], bd


def parallel_helpers():
    """tests/torch_parallel_helpers.py, imported by its own name from this
    directory (another installed package may be called `tests`); spawned
    ranks find it on the path they inherit."""
    import sys
    from pathlib import Path

    here = str(Path(__file__).resolve().parent)
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch_parallel_helpers

    return torch_parallel_helpers


def dp_ranks():
    """(ranks, backend, cards) of the card's DP tests: a card a rank over
    NCCL on two or more cards, else two gloo ranks sharing cuda:0 (NCCL
    refuses two ranks on one card)."""
    cards = torch.cuda.device_count()
    return max(cards, 2), "nccl" if cards >= 2 else "gloo", min(cards, max(cards, 2))


def test_dp_step_launches_k1_and_k2_on_every_rank(cuda, tmp_path):
    """One DP `signerf_nerfacto` step at full width: each rank launches K1
    and K2's tables half three times (its one micro-batch of 4096 / W rays),
    and ends with rank 0's parameters exactly."""
    from signerf_tpu_torch.parallel import mesh as mesh_lib

    hp = parallel_helpers()
    ranks, backend, cards = dp_ranks()
    mesh_lib.spawn(hp.card_step, (str(tmp_path),), ranks, tmp_path, device_type="cuda", backend=backend,
                   cards=cards, join_timeout_s=300)
    for r in range(ranks):
        rec = torch.load(tmp_path / f"card_rank{r}.pt", weights_only=False)
        assert rec["backend"] == backend and rec["device"] == f"cuda:{r % cards}"
        launched = {k: v for k, v in rec["launches"].items() if v}
        assert launched == {"launches": 3, "bwd_table_launches": 3}, (r, launched)
        assert rec["param_diff"] == 0.0 and rec["loss"] == rec["loss"], rec


def test_tp_block_runs_k7_on_each_ranks_heads(cuda, tmp_path):
    """One SDXL transformer block at published widths sharded over a tensor
    group of two ranks (NCCL a card each on two or more cards, else two
    gloo ranks on cuda:0): each rank launches K7 once on its 10 of the 20
    heads, both ranks give the same output bit for bit, and it is within
    2e-2 norm-relative of the whole block (the f32 sum of two bf16
    partials against one bf16 product, per row-parallel layer)."""
    from signerf_tpu_torch.parallel import mesh as mesh_lib

    hp = parallel_helpers()
    _, backend, cards = dp_ranks()
    mesh_lib.spawn(hp.card_tp_block, (str(tmp_path),), 2, tmp_path, device_type="cuda", backend=backend,
                   cards=min(cards, 2), join_timeout_s=300, tensor=2)
    r0, r1 = (torch.load(tmp_path / f"tp_card_rank{r}.pt", weights_only=False) for r in range(2))
    assert (r0["k7"], r0["heads"], r1["k7"], r1["heads"]) == (1, 10, 1, 10)
    assert torch.equal(r0["y"], r1["y"]) and bool(torch.isfinite(r0["y"]).all())
    err = float((r0["y"] - r0["whole"]).norm() / r0["whole"].norm())
    assert 0.0 < err < 2e-2, err


def test_ranks_build_the_kernels_once(cuda, tmp_path):
    """Two ranks that start together on an empty build directory: the file
    lock lets one run nvcc on the six sources, and the other loads them."""
    from signerf_tpu_torch.ops import cuda_build
    from signerf_tpu_torch.parallel import mesh as mesh_lib

    hp = parallel_helpers()
    ranks, backend, cards = dp_ranks()
    mesh_lib.spawn(hp.build_once, (str(tmp_path / "kernels"), str(tmp_path)), ranks, tmp_path, device_type="cuda",
                   backend=backend, cards=cards, join_timeout_s=600)
    recs = [torch.load(tmp_path / f"build_rank{r}.pt", weights_only=False) for r in range(ranks)]
    assert sum(r["nvcc_runs"] for r in recs) == len(cuda_build.SOURCES), recs
    assert all(r["libraries"] == sorted(cuda_build.SOURCES) for r in recs)


# ---------------------------------------------------------------------------
# The eval render's chunk as one CUDA graph (`engine/chunk_graph.py`)

GRAPH_CHUNK = 4096


def graph_model(name, device):
    """A model at full width: "factor" and "hash" `signerf_nerfacto`'s
    nerfacto, "signerf" and "signerf-hash" with gradient and predicted
    normals (K3 and K5 on the base field; autograd through the hash encode)."""
    import dataclasses

    from signerf_tpu_torch.method_configs import signerf_method
    from signerf_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
    from signerf_tpu_torch.models.signerf import SIGNeRFModel

    backend = "hash" if name.endswith("hash") else "factor"
    if name.startswith("signerf"):
        model = SIGNeRFModel(dataclasses.replace(signerf_method().pipeline.model, encoding_backend=backend), 3)
    else:
        model = NerfactoModel(NerfactoModelConfig(encoding_backend=backend), num_train_images=3)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def graph_rays(n, device, seed=1):
    from signerf_tpu_torch.cameras.cameras import RayBundle

    g = torch.Generator().manual_seed(seed)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g) * 0.3 + torch.tensor([0.0, 0.0, -1.0]), dim=-1)
    o = torch.tensor([0.0, 0.0, 2.0]) + 0.1 * torch.randn(n, 3, generator=g)
    return RayBundle(
        origins=o.to(device), directions=d.to(device), pixel_area=torch.ones(n, 1, device=device),
        camera_indices=torch.randint(0, 3, (n, 1), generator=g, dtype=torch.int32).to(device),
        nears=torch.full((n, 1), 0.5, device=device), fars=torch.full((n, 1), 4.0, device=device),
    )


def eager_frame(model, bundle, chunk=GRAPH_CHUNK):
    """`make_eval_render`'s padding and chunk order, each chunk a plain
    model call, concatenated."""
    from signerf_tpu_torch.engine.train_step import EVAL_OUTPUTS

    n = bundle.origins.shape[0]
    pad = -n % chunk
    padded = bundle.map(lambda x: torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]))
    with torch.inference_mode():
        outs = [model(padded.map(lambda x: x[c : c + chunk])) for c in range(0, n + pad, chunk)]
    return {k: torch.cat([o[k] for o in outs])[:n] for k in EVAL_OUTPUTS}


def assert_frames_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


def kernel_counts():
    """The counters a replay must add to as the eager chunks do."""
    from signerf_tpu_torch.utils import tracing

    return {k: v for k, v in tracing.counters().items() if not k.startswith("render.")}


@pytest.mark.parametrize("name,n", [("factor", 3 * GRAPH_CHUNK), ("factor", 3 * GRAPH_CHUNK - 1000),
                                    ("hash", 3 * GRAPH_CHUNK - 1000), ("signerf", 2 * GRAPH_CHUNK + 7),
                                    ("signerf-hash", 2 * GRAPH_CHUNK + 7)])
def test_eval_render_replays_equal_the_eager_chunks_bit_for_bit(cuda, name, n):
    """The first frame captures (its first chunk is the warm-up) and the
    second replays every chunk; both equal the eager chunks bit for bit,
    padded frames too."""
    from signerf_tpu_torch.engine import chunk_graph
    from signerf_tpu_torch.engine.train_step import make_eval_render

    model = graph_model(name, cuda)
    bundle = graph_rays(n, cuda)
    want = eager_frame(model, bundle)
    captures, replays = chunk_graph.graph_captures, chunk_graph.graph_replays
    first = make_eval_render(model, chunk_size=GRAPH_CHUNK)(bundle)
    second = make_eval_render(model, chunk_size=GRAPH_CHUNK)(bundle)
    torch.cuda.synchronize()
    chunks = -(-n // GRAPH_CHUNK)
    assert chunk_graph.graph_captures == captures + 1
    assert chunk_graph.graph_replays == replays + 2 * chunks - 1
    assert_frames_equal(first, want)
    assert_frames_equal(second, want)


def test_eval_render_replays_follow_in_place_weight_updates(cuda):
    """After an Adam-like in-place update (`_foreach_add_`) the graph reads
    the new weights at their addresses: no capture, and the replayed frame
    equals a fresh eager frame."""
    from signerf_tpu_torch.engine import chunk_graph
    from signerf_tpu_torch.engine.train_step import make_eval_render

    model = graph_model("factor", cuda)
    bundle = graph_rays(2 * GRAPH_CHUNK - 100, cuda)
    render = make_eval_render(model, chunk_size=GRAPH_CHUNK)
    before = render(bundle)["rgb"].clone()
    captures = chunk_graph.graph_captures
    g = torch.Generator(device=cuda).manual_seed(3)
    with torch.no_grad():
        params = list(model.parameters())
        torch._foreach_add_(params, [0.05 * torch.randn(p.shape, generator=g, device=cuda) for p in params])
    got = render(bundle)
    torch.cuda.synchronize()
    assert chunk_graph.graph_captures == captures
    assert not torch.equal(got["rgb"], before)
    assert_frames_equal(got, eager_frame(model, bundle))


def test_eval_render_captures_anew_after_a_move_or_another_chunk_size(cuda):
    from signerf_tpu_torch.engine import chunk_graph
    from signerf_tpu_torch.engine.train_step import make_eval_render

    model = graph_model("factor", cuda)
    bundle = graph_rays(2 * GRAPH_CHUNK, cuda)
    start = chunk_graph.graph_captures
    make_eval_render(model, chunk_size=GRAPH_CHUNK)(bundle)
    make_eval_render(model, chunk_size=GRAPH_CHUNK)(bundle)
    assert chunk_graph.graph_captures == start + 1
    make_eval_render(model, chunk_size=GRAPH_CHUNK // 2)(bundle)
    assert chunk_graph.graph_captures == start + 2
    assert len(chunk_graph._models[model].by_key) == 2
    model.cpu().to(cuda)  # new addresses for every weight
    got = make_eval_render(model, chunk_size=GRAPH_CHUNK)(bundle)
    assert chunk_graph.graph_captures == start + 3
    assert len(chunk_graph._models[model].by_key) == 1  # the graphs of the old addresses are gone
    assert_frames_equal(got, eager_frame(model, bundle))


K1_NAME = re.compile(r"(?<![A-Za-z0-9_])density_kernel(?![A-Za-z0-9_])")  # as the profiler names K1


def test_eval_render_counts_as_the_eager_chunks(cuda):
    """A frame adds to K1's launch counter and to `table_pack_bytes` what
    the eager chunks add, the capturing frame and a replayed one alike, and
    the replayed frame's profile holds as many K1 kernels as the counter
    grew: 3 a chunk. The render counters count its chunks and replays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from signerf_tpu_torch.engine.train_step import make_eval_render
    from signerf_tpu_torch.utils import tracing

    model = graph_model("factor", cuda)
    n = 3 * GRAPH_CHUNK - 5
    bundle = graph_rays(n, cuda)
    before = kernel_counts()
    eager_frame(model, bundle)
    eager = {k: v - before[k] for k, v in kernel_counts().items() if v != before[k]}
    assert eager["fused_factor_cuda.launches"] == 3 * 3 and eager["factor_grid.table_pack_bytes"] > 0
    for frame in ("capture", "replay"):
        before, counts = kernel_counts(), tracing.counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            make_eval_render(model, chunk_size=GRAPH_CHUNK)(bundle)
            torch.cuda.synchronize()
        grown = {k: v - before[k] for k, v in kernel_counts().items() if v != before[k]}
        assert grown == eager, frame
        render = {k: v - counts[k] for k, v in tracing.counters().items() if k.startswith("render.")}
        assert render == ({"render.chunks": 3, "render.graph_replays": 2, "render.graph_captures": 1}
                          if frame == "capture" else
                          {"render.chunks": 3, "render.graph_replays": 3, "render.graph_captures": 0}), frame
        k1 = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and K1_NAME.search(e.name)]
        assert len(k1) == grown["fused_factor_cuda.launches"], (frame, k1)
