"""The port's CUDA kernel on the card: K1 against its plain twin, its input
checks, and one model chunk through it.

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
