"""Rank workers of the port's tests of the viewer on a mesh of ranks
(tests/test_torch_interface_ranks.py, and the train CLI's viewer in
tests/test_torch_parallel.py): the train CLI's own work (`train.parse`,
`train._run`) on every rank, rank 0 serving on port 0 and a client thread
there driving the routes, then closing the viewer's channel so that every
rank leaves `run_interface`.

This module imports torch and the port only: spawned ranks re-import it by
name, and no JAX may enter them. Everything a worker needs comes in its
arguments; it saves its results to `out`/<name>_rank{r}.pt.
"""

from __future__ import annotations

import copy
import json
import shutil
import threading
import time
import urllib.error
import urllib.request
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from signerf_tpu_torch.diffusion import sdxl_pipeline as tsdxl
from signerf_tpu_torch.diffusion.diffuser import Diffuser
from signerf_tpu_torch.parallel import mesh as mesh_lib
from tests import torch_parallel_helpers as hp
from tests.torch_parallel_helpers import FakeDiffuser, forbidden_modules

SERVE_TIMEOUT_S = 120.0  # the client's wait for the server and for /generate


def http(url: str, body: Optional[dict] = None, timeout: float = SERVE_TIMEOUT_S):
    """(status, headers, bytes) of a GET (no body) or a POST; an HTTP error's
    status instead of raising."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers, err.read()


def post(base: str, path: str, body: dict) -> tuple:
    status, _, data = http(base + path, body)
    return status, json.loads(data)


def state(base: str) -> dict:
    return json.loads(http(base + "/state")[2])


def params_of(trainer) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in trainer.pipeline.model.state_dict().items()}


def run_viewer(mesh: mesh_lib.DataMesh, argv: List[str], client: Callable[[str, Any, Any], dict],
               diffuser=FakeDiffuser) -> Dict[str, Any]:
    """The train CLI's work on this rank with `diffuser` as the pipeline's
    Diffuser, its viewer on port 0; on rank 0 `client(base, server,
    trainer)` in a thread, then the channel closed. Returns this rank's
    record: the trainer, every "train" command it ran with the step and
    parameters then, its scene elements when /generate started, the words
    it took and the client's result (rank 0)."""
    from signerf_tpu_torch import pipeline as tpipe
    from signerf_tpu_torch import train as train_cli
    from signerf_tpu_torch.engine import trainer as ttrainer
    from signerf_tpu_torch.interface import app

    rec: Dict[str, Any] = {"states": [], "served": [], "reached": 0}
    trainers, servers = [], []
    real = {"setup": ttrainer.SIGNeRFTrainer.setup, "run_interface": app.run_interface,
            "run_command": app.run_command, "start": app.ViewerServer.start_background,
            "channel": app.CommandChannel, "diffuser": tpipe.Diffuser}

    def setup(self, *a, **k):
        trainers.append(self)
        return real["setup"](self, *a, **k)

    def run_interface(trainer, port=7007):
        rec["reached"] += 1
        return real["run_interface"](trainer, port=0)

    def run_command(interface, name, args, kwargs):
        trainer = interface.trainer
        if name == "generate":
            rec["scene"] = {"elements": interface.scene_elements(), "gen_config": copy.deepcopy(interface.gen_config),
                            "circle_params": dict(interface.circle_params)}
        result = real["run_command"](interface, name, args, kwargs)
        if name == "train":
            rec["states"].append((args[0], trainer.step, params_of(trainer)))
        return result

    def start_background(self):
        httpd = real["start"](self)
        servers.append((self, httpd))
        rec["served"].append(httpd.server_address[1])
        return httpd

    channels = []

    def channel(*a, **k):
        channels.append(real["channel"](*a, **k))
        return channels[-1]

    tpipe.Diffuser = diffuser
    ttrainer.SIGNeRFTrainer.setup, app.run_interface, app.run_command = setup, run_interface, run_command
    app.ViewerServer.start_background, app.CommandChannel = start_background, channel
    result: Dict[str, Any] = {}
    thread = None
    try:
        if mesh.is_main:

            def drive():
                try:
                    deadline = time.monotonic() + SERVE_TIMEOUT_S
                    while not servers and time.monotonic() < deadline:
                        time.sleep(0.02)
                    server, httpd = servers[0]
                    result.update(client(f"http://127.0.0.1:{httpd.server_address[1]}", server, trainers[0]))
                except BaseException as exc:  # noqa: BLE001 - reported by the test
                    result["error"] = repr(exc)
                finally:
                    if servers:
                        servers[0][0].channel.close()

            thread = threading.Thread(target=drive, daemon=True)
            thread.start()
        _, _, config, train_only = train_cli.parse(argv)
        t0 = time.monotonic()
        rc = train_cli._run(mesh, config, torch.device("cpu"), train_only)
        rec["wall_s"] = time.monotonic() - t0
    finally:
        tpipe.Diffuser = real["diffuser"]
        ttrainer.SIGNeRFTrainer.setup, app.run_interface = real["setup"], real["run_interface"]
        app.run_command, app.ViewerServer.start_background = real["run_command"], real["start"]
        app.CommandChannel = real["channel"]
    if thread is not None:
        thread.join(SERVE_TIMEOUT_S)
    (trainer,) = trainers
    rec.update(rc=rc, trainer=trainer, client=result, words=channels[0].words if channels else 0,
               word_s=channels[0].word_s if channels else [])
    return rec


def save(out: str, name: str, rank: int, rec: Dict[str, Any]) -> None:
    rec = dict(rec)
    trainer = rec.pop("trainer", None)
    if trainer is not None:
        rec.update(params=params_of(trainer), step=trainer.step, training_state=trainer.training_state,
                   rays_per_call=trainer._num_rays_per_call)
    rec["modules"] = forbidden_modules()
    torch.save(rec, Path(out) / f"{name}_rank{rank}.pt")


# ---------------------------------------------------------------------------
# the viewer's routes on (2, 1): tests/test_torch_interface_ranks.py
# ---------------------------------------------------------------------------

# The mirrored state changes, in order (the JAX interface replays them).
PARAMS = {"prompt": "a blue cube", "num_inference_steps": 3, "seed": 5, "guidance_scale": 6.0}
NUDGES = [{"element": "reference", "translate": [0.1, 0.0, -0.05], "scale": 2.0},
          {"element": "aabb", "translate": [0.1, 0.0, 0.0], "scale": 1.5},
          {"element": "shape", "translate": [0.0, 0.2, 0.0], "rotate_deg": [0, 0, 30]}]
DRAGS = [{"element": "aabb", "dx_px": 4.0, "dy_px": -2.0, "yaw": 20.0, "pitch": 55.0, "radius": 2.0, "size": 128},
         {"element": "reference", "dx_px": -3.0, "dy_px": 1.5, "yaw": 20.0, "pitch": 55.0, "radius": 2.0,
          "size": 128}]
VIEW = "yaw=30&pitch=60&radius=2.0&size=24"
PAUSE_AFTER = 10  # the client pauses the refinement once a step past this shows


def drive_routes(base: str, server, trainer) -> dict:
    """Every route, in order: the state changes (and two bad ones), a pause
    and a resume while idle, /render, /scene, /preview, /generate (and a
    second one while it runs), a pause mid-refinement with /render and
    /preview in it, the resume, /export, the end of /generate."""
    out: Dict[str, Any] = {"codes": {}}
    codes = out["codes"]
    assert http(base + "/")[0] == 200
    codes["params"] = post(base, "/params", PARAMS)
    codes["nudge"] = [post(base, "/nudge", n) for n in NUDGES]
    codes["bad_nudge"] = post(base, "/nudge", {"element": "nope"})  # ValueError on every rank
    codes["no_element"] = post(base, "/nudge", {})  # KeyError before any command
    codes["drag"] = [post(base, "/drag", d) for d in DRAGS]
    codes["idle_pause"] = [post(base, "/train", {"state": s}) for s in ("paused", "training", "paused")]
    status, headers, png = http(f"{base}/render?{VIEW}")
    out["render"] = {"status": status, "png": png, "params": params_of(trainer), "step": trainer.step,
                     "timing": headers["Server-Timing"]}
    out["scene"] = json.loads(http(base + "/scene")[2])
    out["preview"] = post(base, "/preview", {})
    codes["generate"] = [post(base, "/generate", {}), post(base, "/generate", {})]
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    s = state(base)
    while not (s["training_state"] == "training" and s["step"] >= PAUSE_AFTER) and time.monotonic() < deadline:
        time.sleep(0.01)
        s = state(base)
    codes["pause"] = post(base, "/train", {"state": "paused"})
    held = [state(base)]
    time.sleep(0.3)
    held.append(state(base))
    out["held"] = [(h["training_state"], h["step"]) for h in held]
    out["paused_render"] = http(f"{base}/render?{VIEW}")[0]
    out["paused_preview"] = post(base, "/preview", {})[0]
    codes["resume"] = post(base, "/train", {"state": "training"})
    server._generation.result(SERVE_TIMEOUT_S)
    out["final_state"] = state(base)
    codes["export"] = post(base, "/export", {"kind": "mesh", "path": str(Path(trainer.config.output_dir) / "m.obj"),
                                             "resolution": 12, "iso": "p50"})
    out["after_render"] = http(f"{base}/render?{VIEW}")[0]
    out["rays_per_sec"] = json.loads(http(base + "/state")[2])["metrics"].get("train_rays_per_sec")
    return out


def idle_then_generate(idle_s: float) -> Callable:
    def client(base: str, server, trainer) -> dict:
        time.sleep(idle_s)
        t0 = time.monotonic()
        started = post(base, "/generate", {})
        server._generation.result(SERVE_TIMEOUT_S)
        return {"started": started, "generate_s": time.monotonic() - t0, "state": state(base)}

    return client


def dataset_files(root: Path) -> Dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def viewer_suite(mesh: mesh_lib.DataMesh, argv: List[str], headless_argv: List[str], idle_argv: List[str],
                 gen_dir: str, short_rdv: str, short_timeout_s: float, out: str) -> int:
    """On this rank: (1) the viewer through every route (`drive_routes`);
    (2) the headless CLI from the viewer's generated dataset (its
    generator config and reference poses, `--previous-experiment-dir`), the
    viewer's dataset kept aside first; (3) the group made anew with a
    timeout of `short_timeout_s`, the viewer idle for three times that,
    then /generate."""
    torch.set_num_threads(1)
    rec = run_viewer(mesh, argv, drive_routes)
    generated = Path(gen_dir)
    kept = generated.parent / (generated.name + "_viewer")
    if mesh.is_main:
        shutil.copytree(generated, kept)
    mesh.barrier()
    save(out, "viewer", mesh.rank, rec)

    trainers = []
    t0 = time.monotonic()
    hp.train_cli_trainer(mesh, [*headless_argv, "--previous-experiment-dir", str(kept)], trainers)
    save(out, "headless", mesh.rank, {"trainer": trainers[0], "wall_s": time.monotonic() - t0})
    if mesh.is_main:
        torch.save({"viewer": dataset_files(kept), "headless": dataset_files(generated)},
                   Path(out) / "datasets.pt")

    mesh.barrier()
    mesh.close()
    short = mesh_lib.init_mesh(mesh.rank, mesh.world_size, short_rdv, torch.device("cpu"), timeout_s=short_timeout_s)
    try:
        rec = run_viewer(short, idle_argv, idle_then_generate(3 * short_timeout_s))
        save(out, "idle", short.rank, dict(rec, timeout_s=short.timeout_s))
    finally:
        short.close()
    return 0


def cli_viewer(mesh: mesh_lib.DataMesh, argv: List[str], out: str) -> int:
    """The train CLI without --train-only or --skip-interface on this rank:
    rank 0 serves (the client reads /state, then closes), rank 1 follows."""
    torch.set_num_threads(1)

    def client(base, server, trainer):
        return {"state": state(base), "world": server.channel.mesh.world_size}

    rec = run_viewer(mesh, argv, client)
    save(out, "cli", mesh.rank, rec)
    return 0


# ---------------------------------------------------------------------------
# /preview on (1, 2) through the tiny SDXL
# ---------------------------------------------------------------------------


def tiny_diffuser(state: Dict[str, Dict[str, torch.Tensor]], mesh: Optional[mesh_lib.DataMesh]) -> Callable:
    """A stand-in for the pipeline's `Diffuser`: the configured one over the
    tiny SDXL holding `state`, sharded over `mesh`'s tensor group."""

    def make(config, device=None, mesh=mesh):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # RANDOM-INIT: the weights come next
            pipe = tsdxl.SDXLInpaintPipeline.create(config=tsdxl.TINY_SDXL_CONFIG, device="cpu", mesh=mesh)
        pipe.load_state_dicts(state)
        return Diffuser(config, device="cpu", pipeline=pipe, mesh=mesh)

    return make


def tp_preview(mesh: mesh_lib.DataMesh, argv: List[str], state, steps: int, out: str) -> int:
    """The viewer on a (1, 2) mesh, SDXL sharded over the tensor group:
    /params, then /preview."""
    torch.set_num_threads(1)

    def client(base, server, trainer):
        codes = {"params": post(base, "/params", {"num_inference_steps": steps})}
        status, sheets = post(base, "/preview", {})
        return {"codes": codes, "status": status, "sheets": sheets}

    rec = run_viewer(mesh, argv, client, diffuser=tiny_diffuser(state, mesh))
    rec["tensor"] = (mesh.tensor, mesh.view_group, mesh.tensor_rank)
    save(out, "tp", mesh.rank, rec)
    return 0


def sheet_arrays(sheets: Dict[str, str]) -> Dict[str, np.ndarray]:
    import base64

    from signerf_tpu_torch.utils.images import decode_png

    return {k: decode_png(base64.b64decode(v)) for k, v in sheets.items()}
