"""Train CLI: `python -m signerf_tpu_torch.train <method> [--a.b.c value ...]`.

Port of `signerf_tpu/train.py` for the `signerf` and `signerf_nerfacto`
methods: plain training (`--train-only True`); the edit flow in the
built-in web viewer (the default: it serves on port 7007 with training
paused, and its "Generate Dataset & Train" runs the flow); or the edit flow
headless (`--skip-interface True`: generate the edited dataset, hot-swap
it, refine). f32 convolutions (the LPIPS loss of `signerf`) run without
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
  --mesh auto|none     accepted; the port trains on one device
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
from signerf_tpu_torch.render import resolve_device


def _flag(opts, name: str, default: str) -> str:
    return str(opts.pop(name, opts.pop(name.replace("-", "_"), default)))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("methods:", ", ".join(METHODS))
        return 0
    method = argv.pop(0)
    if method not in METHODS:
        print(f"unknown method {method!r}; available: {', '.join(METHODS)}")
        return 1
    config = METHODS[method]()
    overrides = cfglib.parse_cli_overrides(argv)
    train_only = _flag(overrides, "train-only", "false").lower() in ("1", "true", "yes")
    mesh = _flag(overrides, "mesh", "auto")
    if mesh not in ("auto", "none"):
        raise ValueError(f"--mesh {mesh}: the port trains on one device (auto or none)")
    device = resolve_device(_flag(overrides, "device", "cuda"))
    if "data" in overrides:
        overrides["pipeline.datamanager.dataparser.data"] = overrides.pop("data")
    config = cfglib.apply_overrides(config, overrides)

    full_f32_convolutions()
    trainer = SIGNeRFTrainer(config, device)
    trainer.setup()
    if train_only:
        trainer.train()
        return 0
    if config.skip_interface:
        trainer.run_headless()
        return 0
    from signerf_tpu_torch.interface import app

    app.run_interface(trainer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
