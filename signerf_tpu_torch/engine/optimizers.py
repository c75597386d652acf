"""Grouped Adam with per-group exponential-decay schedules.

Port of `signerf_tpu/engine/optimizers.py`. Parameters fall into the JAX
package's groups by name: `proposal_networks` (top-level `proposal*`),
`camera_opt`, `appearance` (any name with an `appearance` part: AdamW with
the fields' schedule and `appearance_weight_decay`) and `fields` (the rest).

One hand-rolled update per group, with the exact math of the JAX fused
update (`optimizers.py:186-213`, which equals `optax.adam` / `optax.adamw`):

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2;  c = count + 1
    u = (m / (1 - b1^c)) / (sqrt(v / (1 - b2^c)) + eps)  [+ wd * p, appearance]
    p = p - lr(count) * u

The learning rate is read at the pre-increment count, so step 0 uses
lr(0). Decoupled decay (`+ wd * p` before the lr scale) is what
`torch.optim.AdamW` does too. The updates run as `torch._foreach_*` ops over
each group's tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

B1, B2 = 0.9, 0.999


@dataclasses.dataclass
class OptimizerGroupConfig:
    lr: float = 1e-2
    eps: float = 1e-15
    lr_final: Optional[float] = 1e-4
    max_steps: int = 200_000
    warmup_steps: int = 0


@dataclasses.dataclass
class OptimizersConfig:
    fields: OptimizerGroupConfig = dataclasses.field(default_factory=OptimizerGroupConfig)
    proposal_networks: OptimizerGroupConfig = dataclasses.field(
        default_factory=OptimizerGroupConfig
    )
    camera_opt: OptimizerGroupConfig = dataclasses.field(
        default_factory=lambda: OptimizerGroupConfig(lr=1e-15, lr_final=None)
    )
    # Weight decay on the per-image appearance codes only: it keeps them
    # near their mean, so eval's mean-code renders stay faithful.
    appearance_weight_decay: float = 0.1


def make_schedule(cfg: OptimizerGroupConfig) -> Callable[[int], float]:
    """count -> lr: optax's `exponential_decay` (floored at `lr_final`), or a
    constant, after an optional linear warmup."""

    def decayed(count: int) -> float:
        if cfg.lr_final is None:
            return cfg.lr
        rate = cfg.lr_final / cfg.lr
        value = cfg.lr * rate ** (count / cfg.max_steps)
        return max(value, cfg.lr_final) if rate < 1.0 else min(value, cfg.lr_final)

    if cfg.warmup_steps <= 0:
        return decayed
    return lambda count: (
        cfg.lr * count / cfg.warmup_steps if count < cfg.warmup_steps
        else decayed(count - cfg.warmup_steps)
    )


def group_of(name: str) -> str:
    """The optimizer group of a parameter, by its dotted state_dict name."""
    parts = name.split(".")
    if "appearance" in parts:
        return "appearance"
    if parts[0].startswith("proposal"):
        return "proposal_networks"
    if parts[0] == "camera_opt":
        return "camera_opt"
    return "fields"


class GroupedAdam:
    """Adam over named parameters, one schedule and state per group."""

    def __init__(self, cfg: OptimizersConfig, named_params: Iterable[Tuple[str, torch.nn.Parameter]]):
        self.cfg = cfg
        self.names: Dict[str, List[str]] = {}
        self.params: Dict[str, List[torch.nn.Parameter]] = {}
        for name, p in named_params:
            g = group_of(name)
            self.names.setdefault(g, []).append(name)
            self.params.setdefault(g, []).append(p)
        self.state = {
            g: {
                "count": 0,
                "m": [torch.zeros_like(p) for p in ps],
                "v": [torch.zeros_like(p) for p in ps],
            }
            for g, ps in self.params.items()
        }

    def _group_cfg(self, group: str) -> OptimizerGroupConfig:
        return self.cfg.fields if group == "appearance" else getattr(self.cfg, group)

    def zero_grad(self) -> None:
        for ps in self.params.values():
            for p in ps:
                p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for group, ps in self.params.items():
            st = self.state[group]
            gcfg = self._group_cfg(group)
            lr = make_schedule(gcfg)(st["count"])
            st["count"] += 1
            c = st["count"]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
            m, v = st["m"], st["v"]
            torch._foreach_mul_(m, B1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - B1))
            torch._foreach_mul_(v, B2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, 1.0 - B2), grads))
            mhat = torch._foreach_div(m, 1.0 - B1**c)
            denom = torch._foreach_sqrt(torch._foreach_div(v, 1.0 - B2**c))
            torch._foreach_add_(denom, gcfg.eps)
            u = torch._foreach_div(mhat, denom)
            if group == "appearance":
                torch._foreach_add_(u, torch._foreach_mul(ps, self.cfg.appearance_weight_decay))
            torch._foreach_add_(ps, torch._foreach_mul(u, -lr))

    def state_dict(self) -> Dict:
        return {"names": self.names, "groups": self.state}

    def load_state_dict(self, state: Dict) -> None:
        if state["names"] != self.names:
            raise ValueError("optimizer state was saved for other parameters")
        for g, st in state["groups"].items():
            self.state[g]["count"] = int(st["count"])
            for dst, src in zip(self.state[g]["m"] + self.state[g]["v"], st["m"] + st["v"]):
                dst.copy_(src)


def make_optimizer(cfg: OptimizersConfig, model: torch.nn.Module) -> GroupedAdam:
    return GroupedAdam(cfg, model.named_parameters())
