"""The port's web viewer on a mesh of ranks (signerf_tpu_torch/interface/app.py
`run_interface`, signerf_tpu_torch/interface/channel.py) on the CPU: rank 0
serves HTTP, every rank runs rank 0's commands in one order.

One spawn of two gloo ranks, (data, tensor) = (2, 1), runs the train CLI's
own work (`train.parse`, `train._run`, no --train-only, no
--skip-interface) with the `custom` fake diffuser; rank 0 serves on port 0
and a client thread there sends, in order: `/params`, `/nudge` (and a bad
one), `/drag`, `/train` pause and resume, `/render`, `/scene`, `/preview`,
`/generate`, a pause mid-refinement with `/render` and `/preview` in it, the
resume, `/export`, and waits for `/generate` to complete. The same ranks
then run the headless CLI (`--skip-interface True`) from the viewer's
generated dataset (`--previous-experiment-dir`: its generator config and
reference poses), and last, on a group made anew with a timeout of a few
seconds, the viewer idles for three times that and then serves
`/generate`. A second spawn, (1, 2), runs `/preview` through the tiny SDXL
sharded over the tensor group.

Checks: (a) both ranks hold bit-equal parameters at each pause and at the
end, and pause at the same step; (b) the refined parameters and the
generated dataset equal the headless CLI's, bit for bit and file for file;
(c) rank 1's scene elements after the mirrored calls match the JAX
`GenerationInterface` driven by the same calls within 1e-6
(tests/test_torch_interface.py's comparison); (d) `/render` equals a
one-rank render of the same parameters; (e) `/preview` on (1, 2) agrees
with one rank's within tests/test_torch_tensor_parallel.py's bounds; (f)
the idle viewer outlives the group's timeout; (g) a bad `/nudge` gives 400
and the next command runs; (h) no rank imports JAX.

The ranks' work lives in tests/torch_interface_ranks_helpers.py, which
imports torch and the port only.
"""

import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from signerf_tpu.data.dataparser import SIGNeRFDataParserConfig as JParserCfg
from signerf_tpu.data.dataparser import parse_transforms as jparse
from signerf_tpu.interface.api import GenerationInterface as JInterface
from signerf_tpu.interface.app import ViewerServer as JViewer
from signerf_tpu_torch import train as train_cli
from signerf_tpu_torch.diffusion import sdxl_pipeline as tsdxl
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer
from signerf_tpu_torch.interface import GenerationInterface
from signerf_tpu_torch.interface.app import ViewerServer
from signerf_tpu_torch.utils.images import decode_png, encode_png
from tests import torch_interface_ranks_helpers as ih
from tests import torch_parallel_helpers as hp
from tests.test_pipeline_e2e import tiny_trainer_config as jax_trainer_config
from tests.test_pipeline_e2e import write_tiny_dataset
from tests.test_torch_interface import assert_same_scene
from tests.test_torch_parallel import CLI_EDIT
from tests.test_torch_tensor_parallel import IMG2IMG_MEAN, TP_MAX
from tests.test_torch_train import _model_flags

torch.set_num_threads(2)

RANKS = 2
STEPS = 40  # refinement steps, 8 calls of 5
IDLE_STEPS = 10
SHORT_TIMEOUT_S = 4.0  # (f): the group's collective timeout
TP_STEPS = 3  # (e): num_inference_steps of the tiny SDXL


def cli_argv(data: Path, out: Path, name: str, steps: int, *extra: str, edit=CLI_EDIT):
    return ["signerf_nerfacto", "--data", str(data), "--device", "cpu", "--mesh", "data=2", "--steps-per-call", "5",
            "--output-dir", str(out), "--experiment-name", name, "--max-num-iterations", str(steps),
            "--steps-per-save", str(steps), *_model_flags("pipeline.model."), *edit,
            "--pipeline.model.background-color", "black", "--pipeline.model.near-plane", "0.5",
            "--pipeline.model.far-plane", "8.0", *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viewer_ranks")
    data = write_tiny_dataset(tmp / "data")
    out = tmp / "out"
    gen = tmp / "gen"
    argv = cli_argv(data, out, "viewer", STEPS, "--pipeline.dataset-generator.path", str(gen))
    headless = cli_argv(data, out, "headless", STEPS, "--skip-interface", "True")
    idle = cli_argv(data, out, "idle", IDLE_STEPS, "--pipeline.dataset-generator.path", str(tmp / "gen_idle"))
    short = (tmp / "short_rendezvous").as_uri()
    hp.spawn(ih.viewer_suite, (argv, headless, idle, str(gen / "experiment"), short, SHORT_TIMEOUT_S, str(tmp)),
             RANKS, tmp)
    load = lambda name: [torch.load(tmp / f"{name}_rank{r}.pt", weights_only=False) for r in range(RANKS)]  # noqa
    return {"tmp": tmp, "data": data, "argv": argv, "viewer": load("viewer"), "headless": load("headless"),
            "idle": load("idle"), "datasets": torch.load(tmp / "datasets.pt", weights_only=False)}


def assert_equal_params(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def test_rank0_serves_and_every_route_answers(run):
    v0, v1 = run["viewer"]
    assert "error" not in v0["client"], v0["client"].get("error")
    assert v0["reached"] == v1["reached"] == 1 and v0["rc"] == v1["rc"] == 0
    assert len(v0["served"]) == 1 and v1["served"] == []  # rank 1 serves nothing
    assert v0["words"] == v1["words"] > 0  # every word reached both ranks
    c = v0["client"]
    codes = c["codes"]
    assert codes["params"] == (200, {"ok": True}) and all(x == (200, {"ok": True}) for x in codes["nudge"])
    assert all(x == (200, {"ok": True}) for x in codes["drag"])
    assert [x[1]["training_state"] for x in codes["idle_pause"]] == ["paused", "training", "paused"]
    assert c["render"]["status"] == 200 and c["preview"][0] == 200
    assert set(c["preview"][1]) == {"image", "mask", "condition", "edited"}
    assert c["scene"]["masking_mode"] == "aabb" and len(c["scene"]["reference_poses"]) == 3
    assert codes["generate"] == [(200, {"started": True}), (200, {"started": False, "reason": "busy"})]
    assert codes["pause"] == (200, {"training_state": "paused"}) and codes["resume"][0] == 200
    assert c["paused_render"] == 200 and c["paused_preview"] == 200 and c["after_render"] == 200
    assert codes["export"][0] == 200 and codes["export"][1]["faces"] > 0
    assert c["final_state"]["training_state"] == "completed" and c["final_state"]["step"] == STEPS
    for rec in run["viewer"]:
        assert rec["step"] == STEPS and rec["training_state"] == "completed"


def test_a_pause_lands_at_one_step_with_equal_parameters(run):
    """(a) Every /train command ran on both ranks at the same step, and the
    parameters then are bit-equal; the mid-refinement pause held the step
    while rank 0 rendered and previewed; the ranks end bit-equal."""
    v0, v1 = run["viewer"]
    assert [s[:2] for s in v0["states"]] == [s[:2] for s in v1["states"]]
    states = [s[:2] for s in v0["states"]]
    assert states[:3] == [("paused", 0), ("training", 0), ("paused", 0)]
    (_, paused_at), (_, resumed_at) = states[3], states[4]
    assert states[3][0] == "paused" and states[4][0] == "training"
    assert ih.PAUSE_AFTER <= paused_at == resumed_at < STEPS and paused_at % 5 == 0
    held = v0["client"]["held"]
    assert held == [("paused", paused_at)] * 2
    for (_, _, p0), (_, _, p1) in zip(v0["states"], v1["states"]):
        assert_equal_params(p0, p1, "at a state change")
    assert_equal_params(v0["params"], v1["params"], "at the end")


def test_viewer_generate_equals_the_headless_cli(run):
    """(b) The viewer's /generate and refinement against the headless
    two-rank CLI run from the viewer's dataset (its config.yml and reference
    poses): the same parameters bit for bit, the same dataset file for file."""
    h0, h1 = run["headless"]
    assert h0["step"] == h1["step"] == STEPS
    assert_equal_params(h0["params"], h1["params"], "headless ranks")
    assert_equal_params(run["viewer"][0]["params"], h0["params"], "viewer against headless")
    sets = run["datasets"]
    assert sorted(sets["viewer"]) == sorted(sets["headless"]) and len(sets["viewer"]) > 20
    for name, data in sets["viewer"].items():
        assert sets["headless"][name] == data, name


def jax_interface(data: Path, tmp: Path) -> JInterface:
    """The JAX `GenerationInterface` over the parts of a trainer it touches:
    tests/test_pipeline_e2e.py's generator config, the dataparser's cameras
    of `data`, a live generator and diffuser whose config it writes."""
    gen_cfg = jax_trainer_config(data, tmp).pipeline.dataset_generator
    generator = types.SimpleNamespace(config=gen_cfg, diffuser=types.SimpleNamespace(config=gen_cfg.diffuser))
    trainer = types.SimpleNamespace(
        config=types.SimpleNamespace(pipeline=types.SimpleNamespace(dataset_generator=gen_cfg)),
        pipeline=types.SimpleNamespace(dataset_generator=generator,
                                       datamanager=types.SimpleNamespace(cameras=jparse(JParserCfg(data=data)).cameras)))
    return JInterface(trainer)


def test_rank1_scene_matches_the_jax_interface(run, tmp_path):
    """(c) The JAX interface driven by the same calls as rank 1 (aligned to
    the CLI's selection first): scene elements within 1e-6."""
    v1 = run["viewer"][1]
    j = jax_interface(run["data"], tmp_path / "jax")
    j.set_selection_aabb((5.0, 5.0, 5.0), (6.0, 6.0, 6.0), inverse_mask=True)
    j.set_generation_params(**ih.PARAMS)
    for n in ih.NUDGES:
        j.nudge(n["element"], translate=tuple(n.get("translate", (0, 0, 0))), scale=float(n.get("scale", 1.0)),
                rotate_deg=tuple(n.get("rotate_deg", (0, 0, 0))))
    with pytest.raises(ValueError):
        j.nudge("nope")
    for d in ih.DRAGS:
        cam = JViewer(j, port=0)._orbit_cam(d["yaw"], d["pitch"], d["radius"], d["size"])
        j.drag(d["element"], d["dx_px"], d["dy_px"], cam)
    if j.reference_poses is None:
        j.set_reference_circle(**j.circle_params)
    rank1 = types.SimpleNamespace(scene_elements=lambda: v1["scene"]["elements"],
                                  gen_config=v1["scene"]["gen_config"], circle_params=v1["scene"]["circle_params"])
    assert_same_scene(j, rank1)
    d = rank1.gen_config.diffuser
    assert {k: getattr(d, k) for k in ih.PARAMS} == ih.PARAMS


def test_render_equals_a_one_rank_render(run, tmp_path):
    """(d) rank 0's /render against `_render_view` of one process holding
    the same parameters (one thread, as the ranks)."""
    c = run["viewer"][0]["client"]["render"]
    _, _, cfg, _ = train_cli.parse(run["argv"])
    cfg.output_dir = tmp_path / "one"
    trainer = SIGNeRFTrainer(cfg, "cpu")
    trainer.setup(diffuser=hp.FakeDiffuser(cfg.pipeline.dataset_generator.diffuser))
    trainer.pipeline.model.load_state_dict(c["params"], strict=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = ViewerServer(GenerationInterface(trainer), port=0)._render_view(30.0, 60.0, 2.0, 24)
    finally:
        torch.set_num_threads(threads)
    got = decode_png(c["png"])
    assert got.shape == (24, 24, 3) and got.std() > 0
    np.testing.assert_array_equal(got, decode_png(encode_png(one)))
    assert sorted(s.split(";")[0] for s in c["timing"].split(", ")) == ["lock", "png", "render"]


def test_idle_viewer_outlives_the_group_timeout(run):
    """(f) On a group with a SHORT_TIMEOUT_S collective timeout, the viewer
    idles for three times that (rank 0 hands out an empty word every
    quarter of it), then /generate runs to completion on both ranks."""
    i0, i1 = run["idle"]
    assert i0["timeout_s"] == i1["timeout_s"] == SHORT_TIMEOUT_S
    assert "error" not in i0["client"], i0["client"].get("error")
    assert i0["client"]["started"] == (200, {"started": True})
    assert i0["client"]["state"]["training_state"] == "completed"
    assert i0["step"] == i1["step"] == IDLE_STEPS
    assert i0["words"] == i1["words"] >= 3 * 4 - 1  # heartbeats while idle
    assert_equal_params(i0["params"], i1["params"], "after the idle viewer's /generate")


def test_bad_nudge_is_a_400_and_the_next_command_runs(run):
    """(g) A nudge of an unknown element raises ValueError on every rank:
    the client gets 400, and the next command (/drag) runs on both."""
    codes = run["viewer"][0]["client"]["codes"]
    assert codes["bad_nudge"][0] == 400 and "unknown scene element" in codes["bad_nudge"][1]["error"]
    assert codes["no_element"][0] == 400
    assert codes["drag"][0] == (200, {"ok": True})


def test_published_rate_is_the_global_batch(run):
    """The render throttle reads train_rays_per_sec: rank 0 publishes the
    mesh's rate, its ticks counting the global batch of every call."""
    v0 = run["viewer"][0]
    assert v0["rays_per_call"] == 64 * 5 and v0["client"]["rays_per_sec"] > 0


def test_no_jax_in_the_ranks(run):
    """(h)"""
    for name in ("viewer", "headless", "idle"):
        assert all(rec["modules"] == [] for rec in run[name]), name


# ---------------------------------------------------------------------------
# (e) /preview on (1, 2): the tiny SDXL sharded over the tensor group
# ---------------------------------------------------------------------------


def test_tp_preview_matches_one_rank(tmp_path):
    """/preview on a (data, tensor) = (1, 2) mesh through the tiny SDXL
    (the port's seeded init, cut to each rank's shards) against one
    process's `preview_generation` with the whole model: the renders, masks
    and conditions equal, the edited sheet within IMG2IMG_MEAN mean and
    TP_MAX max |err|."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        whole = tsdxl.SDXLInpaintPipeline.create(config=tsdxl.TINY_SDXL_CONFIG, device="cpu", seed=0)
    state = {c: getattr(whole, c).state_dict() for c in tsdxl.COMPONENTS}
    data = write_tiny_dataset(tmp_path / "data")
    argv = cli_argv(data, tmp_path / "out", "tp", STEPS, "--pipeline.dataset-generator.path",
                    str(tmp_path / "gen"), edit=[a for a in CLI_EDIT if a not in ("--pipeline.dataset-generator."
                                                                                   "diffuser.mode", "custom")])
    hp.spawn(ih.tp_preview, (argv, state, TP_STEPS, str(tmp_path)), RANKS, tmp_path, tensor=RANKS)
    r0, r1 = (torch.load(tmp_path / f"tp_rank{r}.pt", weights_only=False) for r in range(RANKS))
    assert r0["tensor"] == (2, 0, 0) and r1["tensor"] == (2, 0, 1) and r0["modules"] == r1["modules"] == []
    assert r0["client"]["status"] == 200, r0["client"]
    got = ih.sheet_arrays(r0["client"]["sheets"])

    _, _, cfg, _ = train_cli.parse(argv)
    cfg.output_dir = tmp_path / "one"
    trainer = SIGNeRFTrainer(cfg, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer.setup(diffuser=ih.tiny_diffuser(state, None)(cfg.pipeline.dataset_generator.diffuser))
        iface = GenerationInterface(trainer)
        iface.set_generation_params(num_inference_steps=TP_STEPS)
        one = {k: decode_png(encode_png(v)) for k, v in iface.preview_generation().items()}
    finally:
        torch.set_num_threads(threads)
    assert sorted(got) == sorted(one)
    for k in ("image", "mask", "condition"):
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    err = np.abs(got["edited"].astype(np.float64) - one["edited"]) / 255.0
    assert err.mean() < IMG2IMG_MEAN and err.max() < TP_MAX, (err.mean(), err.max())
    assert not np.array_equal(got["edited"], got["image"])  # the inpaint ran
