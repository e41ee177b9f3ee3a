"""The assigned input-shape set (same 4 shapes for every LM arch); a copy
of ``repro.configs.shapes``.

``train_*`` lowers ``train_step``; ``prefill_*`` lowers ``prefill_step``;
``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV/state
cache of ``seq_len``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def get(name: str) -> ShapeConfig:
    return SHAPES[name]


def applicable(arch, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch × shape) cell."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "pure full-attention arch: 500k ctx needs sub-quadratic attention"
    return True, ""
