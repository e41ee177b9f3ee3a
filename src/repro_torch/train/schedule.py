"""Learning-rate schedules (host-side scalars, fed to the jitted step)."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    kind: str = "cosine"           # "cosine" | "linear" | "constant"
    min_ratio: float = 0.1


def lr_at(cfg: ScheduleConfig, step: int) -> float:
    if step < cfg.warmup_steps:
        return cfg.peak_lr * (step + 1) / max(cfg.warmup_steps, 1)
    if cfg.kind == "constant":
        return cfg.peak_lr
    frac = min(1.0, (step - cfg.warmup_steps)
               / max(cfg.total_steps - cfg.warmup_steps, 1))
    if cfg.kind == "linear":
        return cfg.peak_lr * (1 - (1 - cfg.min_ratio) * frac)
    # cosine
    return cfg.peak_lr * (cfg.min_ratio + (1 - cfg.min_ratio)
                          * 0.5 * (1 + math.cos(math.pi * frac)))
