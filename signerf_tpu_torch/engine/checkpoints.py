"""Checkpoint save/load with SIGNeRF's selective-restore surgery.

Port of `signerf_tpu/engine/checkpoints.py`. A checkpoint is
`step-{step:09d}.pt`, a `torch.save` of ``{"step", "params": state_dict,
"optimizer": optimizer state}``, read back with `weights_only=True`.

The JAX package's checkpoints, `step-{step:09d}.ckpt` (flax msgpack of
``{"step", "params", "opt_state"}``), are read too: `load_jax_checkpoint`
decodes them with a small pure-Python msgpack reader (no `msgpack`
package) into the port's state_dict names, which are the JAX tree paths
joined with dots. Their params and step are carried; their optimizer
state is not (a load restarts Adam, as the restore surgery always does).
`latest_checkpoint` takes a directory's `step-*.ckpt` when it holds no
`step-*.pt`.

Surgery on load, as the reference does (signerf_pipeline.py:93-144): the
appearance codes and the camera-opt pose adjustments are dropped and come
from the model's own fresh init, and optionally so do all `proposal*`
weights (the dataset hot-swap retrains the proposal networks).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def checkpoint_path(directory: Path, step: int) -> Path:
    return Path(directory) / f"step-{step:09d}.pt"


def latest_checkpoint(directory: Path) -> Optional[Path]:
    """The newest `step-*.pt` in `directory`, else its newest JAX
    `step-*.ckpt`, else None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    ckpts = sorted(directory.glob("step-*.pt")) or sorted(directory.glob("step-*.ckpt"))
    return ckpts[-1] if ckpts else None


def save_checkpoint(directory: Path, step: int, params: Dict[str, torch.Tensor], optimizer=None) -> Path:
    """Write host copies of the params (a state_dict) and optimizer state."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    to_cpu = lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [host(v) for v in tree]
        return to_cpu(tree)

    state = {
        "step": int(step),
        "params": host(dict(params)),
        "optimizer": None if optimizer is None else host(optimizer.state_dict()),
    }
    path = checkpoint_path(directory, step)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state, tmp)
    tmp.replace(path)
    return path


def load_checkpoint(path: Path) -> Dict:
    """{"step", "params", "optimizer"} on the CPU; a JAX `.ckpt` gives
    "optimizer" None."""
    path = Path(path)
    if path.suffix == ".ckpt":
        params, step = load_jax_checkpoint(path)
        print(f"[checkpoints] {path.name} is a JAX checkpoint: params and step read, "
              "optimizer state not carried (Adam starts fresh)")
        return {"step": step, "params": params, "optimizer": None}
    return torch.load(path, map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# JAX checkpoints: flax's msgpack layout (flax/serialization.py)
# ---------------------------------------------------------------------------

_EXT_NDARRAY = 1  # msgpack of (shape, dtype name, C-order bytes)
_EXT_NPSCALAR = 3  # the same, of a 0-d array
_CHUNKED = "__msgpack_chunked_array__"  # arrays over 2^30 bytes: {shape, chunks} of flat pieces


# msgpack type bytes -> the struct format of their length (bin, ext, str,
# array, map) or of their value (floats, ints)
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
            0xD2: ">i", 0xD3: ">q"}


class _MsgpackReader:
    """A msgpack decoder over a bytes buffer: maps, arrays, strings, bins,
    ints, floats, nil and bools, and flax's ndarray and numpy-scalar ext
    types (decoded to CPU tensors)."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str) -> Any:
        (val,) = struct.unpack_from(fmt, self._take(struct.calcsize(fmt)))
        return val

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _ext(self, n: int) -> Any:
        code = self._unpack(">b")
        payload = self._take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            return _ndarray_from_msgpack(payload)
        raise ValueError(f"msgpack ext type {code} is not a flax array")

    def read(self) -> Any:
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _LENGTHS:
            n = self._unpack(_LENGTHS[b])
            if b <= 0xC6:
                return bytes(self._take(n))
            if b <= 0xC9:
                return self._ext(n)
            if b <= 0xDB:
                return self._str(n)
            if b <= 0xDD:
                return [self.read() for _ in range(n)]
            return self._map(n)
        if b in _SCALARS:
            return self._unpack(_SCALARS[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return _unchunk(out) if out.get(_CHUNKED) is True else out


def _ndarray_from_msgpack(payload: memoryview) -> torch.Tensor:
    shape, name, data = _MsgpackReader(payload).read()
    if name == "bfloat16":
        flat = torch.from_numpy(np.frombuffer(data, np.uint16).copy()).view(torch.bfloat16)
    else:
        flat = torch.from_numpy(np.frombuffer(data, np.dtype(name)).copy())
    return flat.reshape(tuple(shape))


def _unchunk(node: Dict[str, Any]) -> torch.Tensor:
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)].reshape(-1) for i in range(len(node["chunks"]))]
    return torch.cat(chunks).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """Decode flax `serialization.msgpack_serialize` output: nested dicts
    with CPU tensors for its arrays and numpy scalars."""
    reader = _MsgpackReader(data)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes after the msgpack object")
    return out


def load_jax_checkpoint(path: Path) -> Tuple[Dict[str, torch.Tensor], int]:
    """A JAX package `step-*.ckpt` -> (state_dict of its params, step). The
    names are the params tree's paths joined with dots, as the port's
    modules name them."""
    raw = msgpack_restore(Path(path).read_bytes())
    params: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Dict[str, Any]) -> None:
        for key, val in node.items():
            if isinstance(val, dict):
                walk(f"{prefix}{key}.", val)
            else:
                params[f"{prefix}{key}"] = val

    walk("", raw["params"])
    return params, int(raw["step"])


def strip_appearance_and_camera_opt(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop the appearance codes and camera_opt (signerf_pipeline.py:110-121)."""
    return {
        k: v
        for k, v in params.items()
        if k.split(".")[0] != "camera_opt" and not k.startswith("field.appearance.")
    }


def strip_proposals(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop every top-level `proposal*` entry (signerf_pipeline.py:126-144)."""
    return {k: v for k, v in params.items() if not k.startswith("proposal")}


def merge_with_init(
    loaded: Dict[str, torch.Tensor], init: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """The init state_dict with every entry the surgery kept replaced by the
    loaded one (entries the model does not have are ignored)."""
    return {k: loaded.get(k, v) for k, v in init.items()}


def surgical_restore(
    path: Path, init_params: Dict[str, torch.Tensor], drop_proposals: bool = False
) -> Dict[str, torch.Tensor]:
    """Full SIGNeRF restore: load -> strip appearance/camera-opt ->
    optionally strip proposals -> overlay onto the fresh init."""
    loaded = strip_appearance_and_camera_opt(load_checkpoint(path)["params"])
    if drop_proposals:
        loaded = strip_proposals(loaded)
    return merge_with_init(loaded, init_params)
