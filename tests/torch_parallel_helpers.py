"""Rank workers of the port's data-parallel tests (tests/test_torch_parallel.py
and the card tests): the DP train step, the DP eval render, the generator's
dealt chunks and the headless train CLI, each run by every rank of a
`DataMesh` and, with `mesh=None`, by one process; and on the card a DP
step and one tensor-parallel SDXL block.

This module imports torch and the port only: spawned ranks re-import it by
name, and no JAX may enter them. Everything a worker needs (configs,
weights, images, pixel indices) comes in its arguments.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from signerf_tpu_torch.cameras.cameras import Cameras, RayBundle
from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
from signerf_tpu_torch.engine import optimizers as topt
from signerf_tpu_torch.engine import train_step as tts
from signerf_tpu_torch.generator import datasetgenerator as tgen
from signerf_tpu_torch.models import fields as tfields
from signerf_tpu_torch.models import nerfacto as tnerfacto
from signerf_tpu_torch.models.nerfacto import NerfactoModel
from signerf_tpu_torch.models.signerf import SIGNeRFModel
from signerf_tpu_torch.ops import factor_grid as tfg
from signerf_tpu_torch.parallel import mesh as mesh_lib

# Module prefixes no rank may import.
FORBIDDEN = ("jax", "jaxlib", "flax", "signerf_tpu", "msgpack")
JOIN_TIMEOUT_S = 300.0  # a rank that hangs fails its test instead of the run
GREEN = np.array([0.1, 0.9, 0.1], np.float32)
EDIT_COLOR = np.array([0.2, 0.2, 0.9], np.float32)  # tests/test_pipeline_e2e.py's fake edit
CELL = 12


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def xla_routes() -> None:
    """The CPU tests' contract for the density and the normals (the XLA
    expressions under autograd, as tests/test_torch_train.py patches them)."""
    tfields.fused_density_mlp = tfg.density_mlp_reference
    tnerfacto.factor_density_geo_and_grad = functools.partial(tfields.factor_density_geo_and_grad, xla=True)


def spawn(fn, args, world_size: int, tmp: Path, **kw) -> None:
    """`fn(mesh, *args)` on `world_size` gloo ranks on the CPU, one thread each."""
    kw = {"join_timeout_s": JOIN_TIMEOUT_S, "timeout_s": JOIN_TIMEOUT_S, **kw}
    mesh_lib.spawn(_one_thread, (fn, args), world_size, tmp, device_type="cpu", **kw)


def _one_thread(mesh, fn, args):
    torch.set_num_threads(1)
    return fn(mesh, *args)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def cameras(c2w: np.ndarray, intr: Dict[str, np.ndarray], height: int, width: int) -> Cameras:
    return Cameras(camera_to_worlds=torch.from_numpy(c2w), **{k: torch.from_numpy(v) for k, v in intr.items()},
                   width=width, height=height)


def train_case(mesh: Optional[mesh_lib.DataMesh], case: Dict[str, Any]) -> Dict[str, Any]:
    """`case["steps"]` optimizer steps of `make_train_step(..., mesh=mesh)`
    from `case["state"]`, every step on the fed pixel indices: with a mesh
    rank r's are `case["table"][r]`, without one all ranks' in order.
    Returns each step's metrics, the first step's (averaged) gradients and
    the last parameters."""
    table = np.asarray(case["table"])
    idx = torch.from_numpy(table[mesh.rank] if mesh is not None else table.reshape(-1, 3))
    tts._sample_indices = lambda *a, **k: idx
    cls = SIGNeRFModel if case["signerf"] else NerfactoModel
    model = cls(case["config"], case["num_images"])
    model.load_state_dict(case["state"], strict=True)
    if case.get("lpips") is not None:
        model.lpips_params = case["lpips"]
    opt = topt.make_optimizer(topt.OptimizersConfig(), model)
    cams = cameras(case["c2w"], case["intr"], *case["hw"])
    fn = tts.make_train_step(model, opt, cams, tts.SamplerSettings(**case["settings"]), mesh=mesh)
    images = torch.from_numpy(case["images"])
    metrics, grads = [], None
    for step in range(case["steps"]):
        metrics.append({k: float(v) for k, v in fn(step, images, None, None).items()})
        if step == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"metrics": metrics, "grads": grads, "params": model.state_dict()}


def render_case(mesh: Optional[mesh_lib.DataMesh], case: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A frame's rays (`case["rays"]`, the bundle's fields as arrays), and
    its first `case["ragged"]` rays, through `make_eval_render(..., mesh=mesh)`."""
    model = NerfactoModel(case["config"], case["num_images"])
    model.load_state_dict(case["state"], strict=True)
    render = tts.make_eval_render(model.eval(), chunk_size=case["chunk"], mesh=mesh)
    flat = RayBundle(**{k: torch.from_numpy(v) for k, v in case["rays"].items()})
    out = {k: v.numpy() for k, v in render(flat).items()}
    ragged = render(flat.map(lambda x: x[: case["ragged"]]))
    out.update({f"ragged_{k}": v.numpy() for k, v in ragged.items()})
    return out


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


def sphere_render(c2w: np.ndarray, h: int, w: int, f: float):
    """tests/test_torch_edit_flow.py's analytic sphere on white: rgb and
    along-ray depth, float32, computed in float64 with numpy."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dirs = np.stack([(xs - w / 2) / f, -(ys - h / 2) / f, -np.ones_like(xs)], -1)
    dirs = dirs @ c2w[:3, :3].astype(np.float64).T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = c2w[:3, 3].astype(np.float64)
    b = dirs @ o
    disc = b * b - (o @ o - 0.25)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    normal = o + dirs * t[..., None]
    shade = 0.3 + 0.7 * np.clip(normal[..., 2:3] + 0.5, 0.0, 1.0)
    rgb = np.where(hit[..., None], np.array([0.8, 0.3, 0.2]) * shade, 1.0)
    depth = np.where(hit, t, 3.0)[..., None]
    return rgb.astype(np.float32), depth.astype(np.float32)


def port_render(cameras: Cameras, index: int):
    rgb, depth = sphere_render(cameras.camera_to_worlds[index].numpy(), cameras.height, cameras.width,
                               float(cameras.fx[index]))
    return {"rgb": torch.from_numpy(rgb), "depth": torch.from_numpy(depth)}


def paint_green(original, rendered, mask, condition):
    """tests/test_torch_edit_flow.py's edit stand-in: the masked region painted green."""
    out = np.array(original)
    if mask is not None:
        out[mask[..., 0] > 0.5] = GREEN
    return out


def generate_case(mesh: Optional[mesh_lib.DataMesh], case: Dict[str, Any]) -> str:
    """`generate_dataset` with the analytic render and the `custom` fake
    diffuser, into `case["path"]`; returns the dataset directory."""
    cfg = tgen.DatasetGeneratorConfig(path=Path(case["path"]), diffuser=DiffuserConfig(mode="custom"),
                                      **case["config"])
    gen = tgen.DatasetGenerator(cfg, np.eye(4)[:3], 1.0, lambda p: p, port_render,
                                diffuser=Diffuser(cfg.diffuser, custom_fn=paint_green), device="cpu", mesh=mesh)
    return str(gen.generate_dataset(reference_camera_to_worlds=case["references"],
                                    synthetic_camera_to_worlds=case["views"]))


# ---------------------------------------------------------------------------
# one spawn, many cases
# ---------------------------------------------------------------------------

CASES = {"train": train_case, "render": render_case, "generate": generate_case}


def suite(mesh: mesh_lib.DataMesh, cases: Dict[str, tuple], out: str) -> int:
    """Every case (name -> (kind, case)) on this rank; rank r saves
    {name: result, "modules": ..., "backend": ...} to `out`/rank{r}.pt."""
    xla_routes()
    results = {name: CASES[kind](mesh, case) for name, (kind, case) in cases.items()}
    results["modules"] = forbidden_modules()
    results["backend"] = mesh.backend
    results["world_size"] = mesh.world_size
    torch.save(results, Path(out) / f"rank{mesh.rank}.pt")
    return 0


# ---------------------------------------------------------------------------
# the headless train CLI
# ---------------------------------------------------------------------------


def fake_edit(original, rendered, mask, condition):
    """tests/test_pipeline_e2e.py's fake edit: the middle third of each cell."""
    out = np.array(original)
    rows = max(1, out.shape[0] // CELL)
    cols = max(1, out.shape[1] // CELL)
    for r in range(rows):
        for c in range(cols):
            out[r * CELL + CELL // 3 : r * CELL + 2 * CELL // 3, c * CELL + CELL // 3 : c * CELL + 2 * CELL // 3] = (
                EDIT_COLOR
            )
    return out


class FakeDiffuser(Diffuser):
    """The configured Diffuser with `fake_edit` as its `custom` function (the
    CLI cannot pass a Python callable)."""

    def __init__(self, config, device=None, **kw):
        super().__init__(config, custom_fn=fake_edit, device=device)


def train_cli_trainer(mesh: mesh_lib.DataMesh, argv, trainers: list) -> int:
    """The train CLI's work on this rank (`train.parse` and `train._run`),
    with `FakeDiffuser` as the pipeline's diffuser; its trainer appended to
    `trainers`. Returns the exit code."""
    from signerf_tpu_torch import pipeline as tpipe
    from signerf_tpu_torch import train as train_cli_mod
    from signerf_tpu_torch.engine import trainer as ttrainer

    real_setup, real_diffuser = ttrainer.SIGNeRFTrainer.setup, tpipe.Diffuser

    def setup(self, *a, **k):
        trainers.append(self)
        return real_setup(self, *a, **k)

    tpipe.Diffuser, ttrainer.SIGNeRFTrainer.setup = FakeDiffuser, setup
    try:
        _, _, config, train_only = train_cli_mod.parse(argv)
        return train_cli_mod._run(mesh, config, torch.device("cpu"), train_only)
    finally:
        tpipe.Diffuser, ttrainer.SIGNeRFTrainer.setup = real_diffuser, real_setup


def train_cli(mesh: mesh_lib.DataMesh, argv, out: str) -> int:
    """`train_cli_trainer`, then this rank's final parameters and imported
    modules to `out`/cli_rank{r}.pt."""
    trainers = []
    rc = train_cli_trainer(mesh, argv, trainers)
    (trainer,) = trainers
    torch.save({"params": trainer.pipeline.model.state_dict(), "step": trainer.step,
                "modules": forbidden_modules()}, Path(out) / f"cli_rank{mesh.rank}.pt")
    return rc


# ---------------------------------------------------------------------------
# the reference-scale pass's script
# ---------------------------------------------------------------------------


def narrow(cfg) -> None:
    """The example scripts' CPU tests' `narrow`: a model and batch small
    enough for the CPU; 16 x 16 patches."""
    from signerf_tpu_torch.models.nerfacto import ProposalNetArgs

    cfg.pipeline.model = dataclasses.replace(
        cfg.pipeline.model, max_res=32, hidden_dim=8, hidden_dim_color=8, appearance_embed_dim=4,
        num_proposal_samples_per_ray=(8, 6), num_nerf_samples_per_ray=4, patch_size=16, eval_num_rays_per_chunk=512,
        proposal_net_args_list=(ProposalNetArgs(num_levels=2, max_res=32, hidden_dim=8),
                                ProposalNetArgs(num_levels=2, max_res=32, hidden_dim=8)))
    cfg.pipeline.datamanager.train_num_rays_per_batch = 512
    cfg.pipeline.datamanager.patch_size = 16
    cfg.steps_per_call = 1
    cfg.pipeline.dataset_generator.mask_dilation = (3, 3)


def north_star(mesh: mesh_lib.DataMesh, argv, out: str) -> int:
    """examples/north_star_pass_torch.py's `main` as this rank, narrowed,
    with the `custom` fake diffuser; the result to `out`/ns_rank{r}.pt."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    import north_star_pass_torch as ns

    result = ns.main(argv, configure=narrow, reduced=["model narrowed to the CPU's size"], mesh=mesh,
                     make_diffuser=lambda c: Diffuser(dataclasses.replace(c, mode="custom"), custom_fn=paint_green,
                                                      device="cpu"))
    torch.save({"result": result, "modules": forbidden_modules()}, Path(out) / f"ns_rank{mesh.rank}.pt")
    return 0


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------


def card_step(mesh: mesh_lib.DataMesh, out: str) -> int:
    """One DP `signerf_nerfacto` step of 4096 global rays at full width on
    this rank's card (the seeded init broadcast from rank 0, this rank's own
    sampling generator): its K1 and K2 launches, its loss and the largest
    difference of its parameters from rank 0's, to `out`/card_rank{r}.pt."""
    from signerf_tpu_torch.models.nerfacto import NerfactoModelConfig
    from signerf_tpu_torch.ops import fused_factor_cuda as ffc

    dev = mesh.device
    model = NerfactoModel(NerfactoModelConfig(), 2).reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    mesh.broadcast_module_(model)
    c2w = np.tile(np.eye(4, dtype=np.float32)[None, :3, :], (2, 1, 1))
    c2w[:, 2, 3] = 2.0
    c2w[1, 0, 3] = 0.3
    full = lambda v: np.full(2, v, np.float32)  # noqa: E731
    cams = cameras(c2w, dict(fx=full(60.0), fy=full(60.0), cx=full(32.0), cy=full(32.0)), 64, 64).to(dev)
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)).to(dev)
    fn = tts.make_train_step(model, topt.make_optimizer(topt.OptimizersConfig(), model), cams,
                             tts.SamplerSettings(num_rays=4096, micro_batches=mesh.world_size), mesh=mesh)
    generator = torch.Generator(device=dev).manual_seed(mesh_lib.rank_seed(0, mesh.rank))
    for name in ffc.COUNTERS:
        setattr(ffc, name, 0)
    loss = float(fn(0, images, None, generator)["total_loss"])
    launches = {name: getattr(ffc, name) for name in ffc.COUNTERS}
    worst = 0.0
    for t in model.state_dict().values():
        ref = t.clone()
        mesh.broadcast_([ref])
        worst = max(worst, float((t - ref).abs().max()))
    torch.save({"launches": launches, "loss": loss, "param_diff": worst, "backend": mesh.backend,
                "device": str(dev)}, Path(out) / f"card_rank{mesh.rank}.pt")
    return 0


def card_tp_block(mesh: mesh_lib.DataMesh, out: str) -> int:
    """One SDXL transformer block at published widths (1280 channels, 20
    heads, S = 1024, the context of 77 x 2048) sharded over this rank's
    tensor group, its self-attention through K7 on the rank's heads; on
    rank 0 the whole block on the same seeded weights and inputs. Each
    rank's output, K7 launches and heads to `out`/tp_card_rank{r}.pt."""
    from signerf_tpu_torch.diffusion.layers import init_flax_
    from signerf_tpu_torch.diffusion.sdxl_pipeline import tensor_shard
    from signerf_tpu_torch.diffusion.unet import BasicTransformerBlock
    from signerf_tpu_torch.ops import flash_attention as fa

    dev = mesh.device

    def block(tp):
        with torch.device(dev):
            mod = BasicTransformerBlock(1280, 20, 64, 2048, tp=tp)
        return init_flax_(mod, torch.Generator(device=dev).manual_seed(0)).eval()

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(1, 1024, 1280, generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn(1, 77, 2048, generator=g, device=dev).to(torch.bfloat16)
    sharded = block(tensor_shard(mesh))
    with torch.no_grad():
        fa.launches = 0
        y = sharded(x, ctx)
        torch.cuda.synchronize(dev)
        rec = {"y": y.float().cpu(), "k7": fa.launches, "heads": sharded.attn1.num_heads, "backend": mesh.backend}
        if mesh.is_main:
            rec["whole"] = block(tensor_shard(None))(x, ctx).float().cpu()
    torch.save(rec, Path(out) / f"tp_card_rank{mesh.rank}.pt")
    return 0


def build_once(mesh: mesh_lib.DataMesh, build_dir: str, out: str) -> int:
    """Both ranks ask for the kernel libraries at once from an empty build
    directory; each reports the nvcc processes it started."""
    from signerf_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR = Path(build_dir)
    mesh.barrier()
    cuda_build.library("fused_factor_density")
    torch.save({"nvcc_runs": cuda_build.nvcc_runs, "libraries": sorted(cuda_build._libs)},
               Path(out) / f"build_rank{mesh.rank}.pt")
    return 0


def failing_rank(mesh: mesh_lib.DataMesh) -> int:
    """Rank 1 raises; rank 0 waits for it at a barrier."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    mesh.barrier()
    return 0
