"""Parameter accounting for the perf model (the ``ArchConfig`` hooks
``param_count`` / ``active_param_count``).  Counterpart of
``repro.models.registry``.

``param_count`` is exact by construction: it builds the port's ``Model``
on the ``meta`` device (no allocation) and sums the leaf sizes.
``active_only`` subtracts the never-active share of the routed experts
(the ``blocks.moe.experts.*`` leaves): active = total - routed · (1 -
top_k / n_experts).  The ``Model`` it builds has no FSDP axes, so the
count is of the global parameters whatever the FSDP degree a run shards
them at.
"""
from __future__ import annotations

import functools


@functools.lru_cache(maxsize=64)
def _counts(cfg) -> tuple[int, int]:
    """(total parameters, routed-expert parameters)."""
    from repro_torch.models.model import Model
    total = routed = 0
    for name, p in Model(cfg, device="meta").named_parameters():
        total += p.numel()
        if name.startswith("blocks.moe.experts."):
            routed += p.numel()
    return total, routed


def param_count(cfg, active_only: bool = False) -> int:
    total, routed = _counts(cfg)
    if active_only and cfg.moe.n_experts:
        frac = cfg.moe.top_k / cfg.moe.n_experts
        return int(total - routed * (1.0 - frac))
    return total


def model_flops(cfg, tokens: int, training: bool = True) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference)."""
    n = param_count(cfg, active_only=True)
    return (6.0 if training else 2.0) * n * tokens
