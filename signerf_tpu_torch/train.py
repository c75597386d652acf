"""Train CLI: `python -m signerf_tpu_torch.train <method> [--a.b.c value ...]`.

Port of `signerf_tpu/train.py` for the `signerf` and `signerf_nerfacto`
methods: plain training (`--train-only True`); the edit flow in the
built-in web viewer (the default: it serves on port 7007 with training
paused, and its "Generate Dataset & Train" runs the flow; on a mesh rank 0
serves and the other ranks follow, `interface/app.run_interface`); or the
edit flow headless (`--skip-interface True`: generate the edited dataset,
hot-swap it, refine). f32 convolutions (the LPIPS loss of `signerf`) run without
TF32 on the card.

Flags, as in the JAX CLI:
  --data PATH          dataset (transforms.json or its directory)
  --load-dir PATH      start from the newest step-*.pt there, else the newest
                       JAX step-*.ckpt (params only; restore surgery, step
                       reset to 0)
  --output-dir PATH    experiment output root (checkpoints under
                       <output-dir>/<experiment-name>/<method>/checkpoints)
  --train-only True    plain training, no edit flow
  --skip-interface True           headless edit flow (without it: the viewer,
                       http://<host>:7007)
  --skip-generation True --generated-dataset-dir DIR
                       reuse a generated dataset: straight to the hot swap
  --previous-experiment-dir DIR   reuse a generated dataset's generator
                       config and poses
  --pipeline.dataset-generator.KEY VALUE   generator and diffuser knobs,
                       e.g. --pipeline.dataset-generator.diffuser.prompt "..."
  --mesh SPEC          auto (default) | none | data | data=K | production |
                       data=K,tensor=T | tensor=T: auto is one card when
                       one is visible, else every visible card as the data
                       mesh; data is every visible card, even one (a
                       process group of 1); data=K is K cards; production
                       is every card as (W / 2, 2); data=K,tensor=T is K x
                       T cards in K groups of T consecutive cards, each
                       group holding one SDXL UNet and ControlNet sharded
                       over its cards (tensor parallelism), tensor=T one
                       such group. More than one card runs one process a
                       card over NCCL: the rays of a step and the eval
                       renders split over all the cards, the per-view
                       generation's chunks over the groups. Without a
                       launcher this CLI spawns its own ranks (a file://
                       rendezvous under --output-dir); under one, e.g.
                         torchrun --nproc-per-node 4 -m signerf_tpu_torch.train
                           signerf --data D --train-only True
                       each process joins the launcher's group. The
                       viewer on more than one rank: rank 0 serves on port
                       7007 and every rank runs its commands in one order
                       (its /preview and /generate on the mesh).
  --device DEV         torch device (default cuda); `cuda` without a card raises
  --a.b.c VALUE        any SIGNeRFTrainerConfig field, e.g.
                       --max-num-iterations 300 --pipeline.model.use-camera-opt True
                       --pipeline.model.encoding-backend hash

Checkpoints are `step-{step:09d}.pt`: a `torch.save` of {"step", "params"
(the model's state_dict), "optimizer"}.
"""

from __future__ import annotations

import sys

from signerf_tpu_torch import config as cfglib
from signerf_tpu_torch.engine.trainer import SIGNeRFTrainer
from signerf_tpu_torch.method_configs import METHODS
from signerf_tpu_torch.ops.lpips import full_f32_convolutions
from signerf_tpu_torch.parallel import mesh as mesh_lib
from signerf_tpu_torch.render import resolve_device


def _flag(opts, name: str, default: str) -> str:
    return str(opts.pop(name, opts.pop(name.replace("-", "_"), default)))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("methods:", ", ".join(METHODS))
        return 0
    if argv[0] not in METHODS:
        print(f"unknown method {argv[0]!r}; available: {', '.join(METHODS)}")
        return 1
    mesh_spec, device, config, train_only = parse(argv)
    return mesh_lib.run(mesh_spec, device, config.output_dir, _run, (config, device, train_only))


def parse(argv):
    """`<method> [--flag value ...]` -> (mesh spec, device, config, train_only)."""
    argv = list(argv)
    config = METHODS[argv.pop(0)]()
    overrides = cfglib.parse_cli_overrides(argv)
    train_only = _flag(overrides, "train-only", "false").lower() in ("1", "true", "yes")
    mesh_spec = _flag(overrides, "mesh", "auto")
    device = resolve_device(_flag(overrides, "device", "cuda"))
    if "data" in overrides:
        overrides["pipeline.datamanager.dataparser.data"] = overrides.pop("data")
    return mesh_spec, device, cfglib.apply_overrides(config, overrides), train_only


def _run(mesh, config, device, train_only: bool) -> int:
    """One rank's work (`mesh` None: the one-device run)."""
    if mesh is not None:
        device = mesh.device
        mesh.print(f"[train] mesh (data, tensor) = ({mesh.view_groups}, {mesh.tensor}): {mesh.world_size} ranks "
                   f"over {mesh.backend}", flush=True)
    from signerf_tpu_torch.interface import app

    full_f32_convolutions()
    trainer = SIGNeRFTrainer(config, device, mesh=mesh)
    trainer.setup()
    if train_only:
        trainer.train()
        return 0
    if config.skip_interface:
        trainer.run_headless()
        return 0
    app.run_interface(trainer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
