"""Nested dataclass configs: dotted CLI overrides and the YAML round-trip.

Port of `signerf_tpu/config.py`. Values are coerced to the annotated field
type; unknown keys raise. `to_yaml` / `from_yaml` are the JAX package's own
emitter and reader over the JSON subset of YAML (no pyyaml), so a
`config.yml` written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from pathlib import Path
from typing import Any, Dict, List, Tuple, Type, TypeVar, Union

T = TypeVar("T")


def to_dict(cfg: Any) -> Any:
    """A dataclass tree as plain JSON-able Python, each dataclass with its
    `__class__` name."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        out = {"__class__": type(cfg).__name__}
        for f in dataclasses.fields(cfg):
            out[f.name] = to_dict(getattr(cfg, f.name))
        return out
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, Path):
        return str(cfg)
    if hasattr(cfg, "tolist"):  # numpy scalars and arrays, tensors
        return cfg.tolist()
    return cfg


def _strip_optional(tp: Any) -> Any:
    if typing.get_origin(tp) is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(value: Any, tp: Any) -> Any:
    """Coerce `value` to the annotated type `tp`."""
    if value is None:
        return None
    tp = _strip_optional(tp)
    origin = typing.get_origin(tp)
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return from_dict(tp, value)
    if tp is Any:
        return value
    if origin in (tuple, Tuple):
        args = typing.get_args(tp)
        seq = value if isinstance(value, (list, tuple)) else json.loads(str(value))
        if args and args[-1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in seq)
        if args:
            return tuple(_coerce(v, a) for v, a in zip(seq, args))
        return tuple(seq)
    if origin in (list, List):
        args = typing.get_args(tp)
        seq = value if isinstance(value, (list, tuple)) else json.loads(str(value))
        return [_coerce(v, args[0]) if args else v for v in seq]
    if origin in (dict, Dict):
        return dict(value)
    if tp is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "on")
    if tp in (int, float, str, Path):
        return tp(value)
    return value


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build dataclass `cls` from a plain dict."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, val in data.items():
        if key == "__class__":
            continue
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        kwargs[key] = _coerce(val, hints.get(key, Any))
    return cls(**kwargs)


def apply_overrides(cfg: T, overrides: Dict[str, Any]) -> T:
    """A copy of `cfg` with dotted-path overrides applied; dashes in path
    components become underscores."""
    for dotted, value in overrides.items():
        cfg = _set_path(cfg, [p.replace("-", "_") for p in dotted.split(".")], value)
    return cfg


def _set_path(cfg: Any, parts: List[str], value: Any) -> Any:
    name = parts[0]
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"cannot descend into non-dataclass at {name!r}")
    names = [f.name for f in dataclasses.fields(cfg)]
    if name not in names:
        raise KeyError(f"unknown config key {name!r} on {type(cfg).__name__} (valid: {names})")
    if len(parts) == 1:
        new_val = _coerce(value, typing.get_type_hints(type(cfg)).get(name, Any))
    else:
        new_val = _set_path(getattr(cfg, name), parts[1:], value)
    return dataclasses.replace(cfg, **{name: new_val})


def parse_cli_overrides(argv: List[str]) -> Dict[str, Any]:
    """``--a.b.c value`` / ``--a.b.c=value`` pairs -> {"a.b.c": value}."""
    overrides: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --key, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for {tok!r}")
            val = argv[i + 1]
            i += 2
        overrides[key] = val
    return overrides


def _emit(obj: Any, indent: int) -> List[str]:
    pad = "  " * indent
    lines: List[str] = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.extend(_emit(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {json.dumps(v)}")
    elif isinstance(obj, list):
        for v in obj:
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}-")
                lines.extend(_emit(v, indent + 1))
            else:
                lines.append(f"{pad}- {json.dumps(v)}")
    else:
        lines.append(f"{pad}{json.dumps(obj)}")
    return lines


def to_yaml(cfg: Any) -> str:
    return "\n".join(_emit(to_dict(cfg), 0)) + "\n"


def _parse_block(lines: List[str], pos: int, indent: int) -> Tuple[Any, int]:
    """One block of `_emit`'s output: a list or a dict, by its first line."""
    result: Any = None
    while pos < len(lines):
        raw = lines[pos]
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            pos += 1
            continue
        if (len(raw) - len(raw.lstrip())) // 2 < indent:
            break
        if stripped.startswith("- ") or stripped == "-":
            if result is None:
                result = []
            if stripped == "-":
                child, pos = _parse_block(lines, pos + 1, indent + 1)
                result.append(child)
            else:
                result.append(json.loads(stripped[2:]))
                pos += 1
        else:
            if result is None:
                result = {}
            key, _, rest = stripped.partition(":")
            rest = rest.strip()
            if rest == "":
                child, pos = _parse_block(lines, pos + 1, indent + 1)
                result[key] = child if child is not None else {}
            else:
                result[key] = json.loads(rest)
                pos += 1
    return result, pos


def from_yaml(cls: Type[T], text: str) -> T:
    data, _ = _parse_block(text.split("\n"), 0, 0)
    return from_dict(cls, data or {})


def save_yaml(cfg: Any, path: Union[str, Path]) -> None:
    Path(path).write_text(to_yaml(cfg))


def load_yaml(cls: Type[T], path: Union[str, Path]) -> T:
    return from_yaml(cls, Path(path).read_text())
