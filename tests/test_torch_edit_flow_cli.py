"""The port's headless edit flow at 24 px, as tests/test_pipeline_e2e.py
drives the JAX package's: train, generate the edited dataset with a fake
diffuser, hot-swap it, refine; the edit lands in the NeRF and the rest of
each view tracks its ground truth; the merge with the original photos.
Then the train CLI's edit-flow modes
with `--device cpu` (headless with a previous experiment's poses,
`--skip-generation`, the hand-off to the viewer) and `--device cuda` without a
card.
"""

import json

import numpy as np
import pytest
import torch

from signerf_tpu_torch.cameras.poses import circle_poses
from signerf_tpu_torch.data.datamanager import SIGNeRFDataManagerConfig
from signerf_tpu_torch.data.dataparser import SIGNeRFDataParserConfig
from signerf_tpu_torch.diffusion.diffuser import Diffuser, DiffuserConfig
from signerf_tpu_torch.engine.checkpoints import load_checkpoint
from signerf_tpu_torch.engine.optimizers import OptimizersConfig
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer, SIGNeRFTrainerConfig
from signerf_tpu_torch.generator.datasetgenerator import DatasetGeneratorConfig
from signerf_tpu_torch.models.nerfacto import ProposalNetArgs
from signerf_tpu_torch.models.signerf import SIGNeRFModelConfig
from signerf_tpu_torch.pipeline import SURGERY_SEED, SIGNeRFPipelineConfig, seeded_model
from signerf_tpu_torch.utils.images import load_rgb
from tests.test_pipeline_e2e import EDIT_COLOR, EDIT_HI, EDIT_LO, N_CAMS, fake_diffuse, write_tiny_dataset
from tests.test_torch_train import _model_flags

torch.set_num_threads(2)


def tiny_trainer_config(data_dir, out_dir) -> SIGNeRFTrainerConfig:
    """tests/test_pipeline_e2e.py's `tiny_trainer_config` in the port's knobs
    (the factor grid's; the hash-grid knobs are not the port's)."""
    model = SIGNeRFModelConfig(
        max_res=64, hidden_dim=16, hidden_dim_color=16, appearance_embed_dim=4,
        num_proposal_samples_per_ray=(12, 8), num_nerf_samples_per_ray=6,
        proposal_net_args_list=(ProposalNetArgs(num_levels=2, max_res=32, hidden_dim=8),
                                ProposalNetArgs(num_levels=2, max_res=64, hidden_dim=8)),
        use_lpips=False, use_l1=True, far_plane=8.0, eval_num_rays_per_chunk=256, near_plane=0.5,
        background_color="black",
    )
    return SIGNeRFTrainerConfig(
        method_name="signerf_test",
        output_dir=out_dir,
        experiment_name="e2e",
        pipeline=SIGNeRFPipelineConfig(
            datamanager=SIGNeRFDataManagerConfig(dataparser=SIGNeRFDataParserConfig(data=data_dir),
                                                 train_num_rays_per_batch=64, patch_size=1),
            model=model,
            dataset_generator=DatasetGeneratorConfig(
                path=out_dir / "generations", dataset_name="edit0", downscale_factor=2, rows=2, cols=2,
                # test_pipeline_e2e.py's selection: a box outside every ray and
                # inverse_mask, so the mask is all ones and the fake edit
                # reaches every view whatever the toy NeRF's depth
                masking_mode="aabb", aabb_min=(5.0, 5.0, 5.0), aabb_max=(6.0, 6.0, 6.0), mask_dilation=(3, 3),
                inverse_mask=True, diffuser=DiffuserConfig(mode="custom"),
            ),
        ),
        optimizers=OptimizersConfig(),
        max_num_iterations=200,
        steps_per_call=25,
        steps_per_save=200,
        skip_interface=True,
    )


def render_view(trainer, index: int) -> np.ndarray:
    return trainer.pipeline.render_camera_fn(trainer.pipeline.datamanager.cameras, index)["rgb"].numpy()


def test_headless_flow_lands_the_edit(tmp_path):
    data = write_tiny_dataset(tmp_path / "data")
    cfg = tiny_trainer_config(data, tmp_path / "out")
    trainer = SIGNeRFTrainer(cfg, "cpu")
    trainer.setup(diffuser=Diffuser(cfg.pipeline.dataset_generator.diffuser, custom_fn=fake_diffuse))
    for _ in range(4):
        metrics = trainer.train_iteration()
    assert trainer.step == 100 and np.isfinite(float(metrics["total_loss"]))

    ref = circle_poses(3, radius=2.0, theta=60.0, phi=(0.0, 240.0)).numpy()[:, :3]
    generated = trainer.generate_dataset(reference_camera_to_worlds=ref)
    t = json.loads((generated / "transforms.json").read_text())
    assert len(t["frames"]) == 3 + N_CAMS and t["generated_indices"] == list(range(3, 3 + N_CAMS))
    assert len(list((generated / "originals").glob("*.png"))) == N_CAMS  # the datamanager's photos

    before = {k: v.clone() for k, v in trainer.pipeline.model.state_dict().items()}
    trainer.exchange_training_dataset(generated)
    assert trainer.step == 0
    assert trainer.pipeline.datamanager.num_images == 3 + N_CAMS
    # the hot swap's surgery: proposal networks and appearance codes from the
    # fresh seeded init (the model now has 9 images), the rest from the
    # checkpoint written just before the swap
    ckpt = load_checkpoint(sorted(trainer.checkpoint_dir.glob("step-*.pt"))[-1])["params"]
    fresh = seeded_model(cfg.pipeline.model, 3 + N_CAMS, SURGERY_SEED).state_dict()
    swapped = trainer.pipeline.model.state_dict()
    for key, val in swapped.items():
        if key.startswith("proposal") or key.startswith("field.appearance."):
            torch.testing.assert_close(val, fresh[key], rtol=0, atol=0, msg=key)
        else:
            torch.testing.assert_close(val, ckpt[key], rtol=0, atol=0, msg=key)
            torch.testing.assert_close(val, before[key], rtol=0, atol=0, msg=key)
    assert any(not torch.equal(swapped[k], before[k]) for k in swapped if k.startswith("proposal"))

    view = t["generated_indices"][0]
    target = load_rgb(generated / t["frames"][view]["file_path"]).astype(np.float32) / 255.0
    box = (slice(EDIT_LO, EDIT_HI), slice(EDIT_LO, EDIT_HI))
    inner = (slice(EDIT_LO + 2, EDIT_HI - 2), slice(EDIT_LO + 2, EDIT_HI - 2))
    assert np.abs(target[inner] - EDIT_COLOR).mean() < 0.05  # the dataset carries the edit
    pre = float(np.abs(render_view(trainer, view)[box] - EDIT_COLOR).mean())

    trainer.train()
    assert trainer.training_state == "completed" and trainer.step >= cfg.max_num_iterations
    assert sorted(p.name for p in trainer.checkpoint_dir.glob("step-*.pt"))[-1] == "step-000000200.pt"
    post_img = render_view(trainer, view)
    post = float(np.abs(post_img[box] - EDIT_COLOR).mean())
    assert post < pre - 0.05, f"the edit did not land: {pre:.3f} -> {post:.3f}"
    outside = np.ones(post_img.shape[:2], bool)
    outside[box] = False
    assert float(np.abs(post_img[outside] - target[outside]).mean()) < 0.3
    row = json.loads(trainer.writer.events_path.read_text().strip().split("\n")[-1])
    assert "total_loss" in row and "psnr" in row


# ---------------------------------------------------------------------------
# The train CLI's edit-flow modes
# ---------------------------------------------------------------------------


class FakeDiffuser(Diffuser):
    """The configured Diffuser with test_pipeline_e2e.py's fake edit as its
    `custom` function (the CLI cannot pass a Python callable)."""

    def __init__(self, config, device=None, **kw):
        super().__init__(config, custom_fn=fake_diffuse, device=device)


CLI_EDIT = [
    "--pipeline.datamanager.train-num-rays-per-batch", "64",
    "--pipeline.dataset-generator.rows", "2", "--pipeline.dataset-generator.cols", "2",
    "--pipeline.dataset-generator.aabb-min", "[5.0, 5.0, 5.0]",
    "--pipeline.dataset-generator.aabb-max", "[6.0, 6.0, 6.0]",
    "--pipeline.dataset-generator.inverse-mask", "True",
    "--pipeline.dataset-generator.mask-dilation", "[3, 3]",
    "--pipeline.dataset-generator.diffuser.mode", "custom",
]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny dataset, a 4-step checkpoint of it and a dataset generated from
    it by the headless CLI (the previous experiment of the other runs)."""
    from signerf_tpu_torch import pipeline as tpipe
    from signerf_tpu_torch import train as train_cli

    tmp = tmp_path_factory.mktemp("cli")
    data = write_tiny_dataset(tmp / "data")
    out = tmp / "out"
    base = ["signerf_nerfacto", "--data", str(data), "--device", "cpu", "--steps-per-call", "2",
            "--output-dir", str(out), *_model_flags("pipeline.model."), *CLI_EDIT]
    assert train_cli.main([*base, "--train-only", "True", "--max-num-iterations", "4",
                           "--experiment-name", "pre"]) == 0
    ckpt_dir = out / "pre" / "signerf_nerfacto" / "checkpoints"
    # A previous experiment supplies the reference poses (and its config).
    prev = tmp / "prev"
    prev.mkdir()
    poses = circle_poses(3, radius=2.0, theta=60.0, phi=(0.0, 240.0)).numpy()
    frames = [{"file_path": f"./images/image_{i}.png", "transform_matrix": p.tolist()} for i, p in enumerate(poses)]
    (prev / "transforms.json").write_text(json.dumps({"frames": frames, "reference_indices": [0, 1, 2]}))
    mp = pytest.MonkeyPatch()
    mp.setattr(tpipe, "Diffuser", FakeDiffuser)
    try:
        rc = train_cli.main([*base, "--skip-interface", "True", "--load-dir", str(ckpt_dir),
                             "--previous-experiment-dir", str(prev), "--max-num-iterations", "4",
                             "--experiment-name", "edit", "--pipeline.dataset-generator.path", str(tmp / "gen")])
    finally:
        mp.undo()
    assert rc == 0
    return {"tmp": tmp, "data": data, "base": base, "ckpt_dir": ckpt_dir, "gen": tmp / "gen" / "experiment",
            "out": out}


def test_headless_cli_generates_swaps_and_refines(trained):
    gen = trained["gen"]
    t = json.loads((gen / "transforms.json").read_text())
    assert t["reference_indices"] == [0, 1, 2] and len(t["generated_indices"]) == N_CAMS
    ckpts = sorted((trained["out"] / "edit" / "signerf_nerfacto" / "checkpoints").glob("step-*.pt"))
    # the exchange's checkpoint at step 0, then the refinement's
    assert [p.name for p in ckpts] == ["step-000000000.pt", "step-000000004.pt"]
    assert load_checkpoint(ckpts[-1])["params"]["field.appearance.embedding"].shape[0] == 3 + N_CAMS
    cfg_text = (trained["out"] / "edit" / "signerf_nerfacto" / "config.yml").read_text()
    assert cfg_text.startswith('__class__: "SIGNeRFTrainerConfig"')


@pytest.mark.parametrize("interface", [False, True])
def test_skip_generation_cli(trained, capsys, monkeypatch, interface):
    """`--skip-generation True --generated-dataset-dir` goes straight to the
    exchange; without `--skip-interface True` the CLI hands the set-up
    trainer to the viewer (`interface.app.run_interface`), and nothing
    trains until its "Generate Dataset & Train"."""
    from signerf_tpu_torch import train as train_cli
    from signerf_tpu_torch.interface import app

    handed = []
    monkeypatch.setattr(app, "run_interface", handed.append)
    name = f"swap{int(interface)}"
    argv = [*trained["base"], "--skip-generation", "True", "--generated-dataset-dir", str(trained["gen"]),
            "--load-dir", str(trained["ckpt_dir"]), "--max-num-iterations", "2", "--experiment-name", name]
    if not interface:
        argv += ["--skip-interface", "True"]
    assert train_cli.main(argv) == 0
    assert "viewer dependencies unavailable" not in capsys.readouterr().out
    ckpts = sorted((trained["out"] / name / "signerf_nerfacto" / "checkpoints").glob("step-*.pt"))
    if not interface:
        assert handed == []
        assert [p.name for p in ckpts] == ["step-000000000.pt", "step-000000002.pt"]
        return
    (trainer,) = handed
    assert trainer.config.experiment_name == name and not trainer.config.skip_interface
    assert trainer.step == 0 and trainer.training_state == "paused" and ckpts == []
    assert trainer.pipeline.datamanager.num_images == N_CAMS  # the original dataset until the exchange
    loaded = load_checkpoint(sorted(trained["ckpt_dir"].glob("step-*.pt"))[-1])["params"]
    state = trainer.pipeline.model.state_dict()
    for key in ("field.mlp_base.dense_0.kernel", "proposal_0.MLP_0.dense_0.kernel"):
        torch.testing.assert_close(state[key], loaded[key], rtol=0, atol=0, msg=key)


def test_previous_experiment_restores_generator_config(trained):
    """A generated dataset's config.yml replaces the configured generator
    config, and its transforms.json supplies the reference poses."""
    cfg = tiny_trainer_config(trained["data"], trained["tmp"] / "restore")
    cfg.previous_experiment_dir = trained["gen"]
    trainer = SIGNeRFTrainer(cfg, "cpu")
    assert trainer.config.pipeline.dataset_generator.dataset_name == "experiment"
    assert trainer.config.pipeline.dataset_generator.rows == 2
    trainer.setup(diffuser=Diffuser(DiffuserConfig(mode="custom"), custom_fn=fake_diffuse))
    assert trainer.previous_cameras["reference_camera_to_worlds"].shape == (3, 3, 4)
    assert trainer.previous_cameras["synthetic_camera_to_worlds"] is None


def test_edit_flow_cli_refuses_cuda_without_a_card(trained, monkeypatch):
    from signerf_tpu_torch import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in trained["base"] if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([*argv, "--skip-interface", "True", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([*argv, "--skip-interface", "True"])  # the default device is the card


def test_trainer_merge_keeps_the_original_photos(tmp_path):
    """`merge_with_original_dataset`: the datamanager's photos are appended
    under inverted masks, each written as its own edited image."""
    data = write_tiny_dataset(tmp_path / "data")
    cfg = tiny_trainer_config(data, tmp_path / "out")
    trainer = SIGNeRFTrainer(cfg, "cpu")
    trainer.setup(diffuser=Diffuser(cfg.pipeline.dataset_generator.diffuser, custom_fn=fake_diffuse))
    ref = circle_poses(3, radius=2.0, theta=60.0, phi=(0.0, 240.0)).numpy()[:, :3]
    syn = circle_poses(2, radius=2.0, theta=75.0, phi=(0.0, 180.0)).numpy()[:, :3]
    out = trainer.generate_dataset(reference_camera_to_worlds=ref, synthetic_camera_to_worlds=syn,
                                   merge_with_original_dataset=True)
    t = json.loads((out / "transforms.json").read_text())
    assert t["is_combined"] is True and t["original_indices"] == list(range(5, 5 + N_CAMS))
    photos = trainer.pipeline.datamanager.images.numpy()
    for k, idx in enumerate(t["original_indices"]):
        np.testing.assert_array_equal(load_rgb(out / "images" / f"image_{idx}.png"), photos[k])
