"""AdamW with global-norm clipping.  Counterpart of the replicated-parameter
parts of ``repro.train.optimizer`` (``OptConfig``, ``global_norm``,
``clip_by_global_norm``, ``AdamW``).

Parameters are fp32 and replicated over the data axis in this slice, so
the global norm needs no collective.  ``AdamW.update`` writes the new parameters and
moments in place to save a copy of each; it returns the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"             # "adamw" | "adafactor" | "sgdm"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0          # 0 = off
    adafactor_eps1: float = 1e-30
    adafactor_clip: float = 1.0
    momentum: float = 0.9


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """fp32 L2 norm over every leaf, summed in leaf order."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + g.float().square().sum()
    return total.sqrt()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], norm


class AdamW:
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "t": 0}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor], lr: float):
        c = self.cfg
        if c.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, c.grad_clip)
        else:
            gnorm = global_norm(grads)
        t = state["t"] + 1
        bc1 = 1.0 - c.b1 ** t
        bc2 = 1.0 - c.b2 ** t
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            g = g.float()
            m.mul_(c.b1).add_(g, alpha=1 - c.b1)
            v.mul_(c.b2).addcmul_(g, g, value=1 - c.b2)
            step = (m / bc1) / ((v / bc2).sqrt_() + c.eps)
            step.add_(p, alpha=c.weight_decay)
            p.sub_(step, alpha=lr)
        return params, {"m": state["m"], "v": state["v"], "t": t}, \
            {"grad_norm": gnorm}


def make(name: str, cfg: OptConfig) -> AdamW:
    if name != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    return AdamW(cfg)
