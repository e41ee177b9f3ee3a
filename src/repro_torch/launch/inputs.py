"""Stand-ins for every model input: ``meta`` tensors of the shapes and
dtypes a step or a serving call is given, with no allocation.
Counterpart of ``repro.launch.inputs``.

Each function returns ``(tensors, split)``: name -> ``meta`` tensor of the
GLOBAL batch, and name -> the dim that is split over the DP axes (the
counterpart of the JAX package's ``PartitionSpec``), or None where the
input is replicated (no DP axes, or a context-parallel batch too small to
split).  ``mrope_positions`` ``(3, B, S)`` is split on dim 1, every
other input on dim 0.  The modality frontends are stubs, as in the JAX
package: the vlm family gets precomputed patch and text ``embeds`` and
the audio family precomputed frame ``enc_embeds``;
``with_frontend_inputs`` draws them for a real batch.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_inputs(arch: ArchConfig, shape: ShapeConfig,
                 dp_axes: Sequence[str]) -> tuple[dict, dict]:
    """The train batch: ``embeds`` bf16 ``(gb, s, d_model)`` and
    ``mrope_positions`` int32 ``(3, gb, s)`` for the vlm family,
    ``enc_embeds`` bf16 and ``tokens`` for the audio family, ``tokens``
    otherwise; ``labels`` int32 ``(gb, s)`` always."""
    gb, s = shape.global_batch, shape.seq_len
    dp = 0 if tuple(dp_axes) else None
    out: dict = {}
    split: dict = {}
    if arch.family == "vlm":
        out["embeds"] = _meta((gb, s, arch.d_model), torch.bfloat16)
        split["embeds"] = dp
        out["mrope_positions"] = _meta((3, gb, s), torch.int32)
        split["mrope_positions"] = None if dp is None else 1
    elif arch.family == "audio":
        out["enc_embeds"] = _meta((gb, s, arch.d_model), torch.bfloat16)
        split["enc_embeds"] = dp
        out["tokens"] = _meta((gb, s), torch.int32)
        split["tokens"] = dp
    else:
        out["tokens"] = _meta((gb, s), torch.int32)
        split["tokens"] = dp
    out["labels"] = _meta((gb, s), torch.int32)
    split["labels"] = dp
    return out, split


def prefill_inputs(arch: ArchConfig, shape: ShapeConfig,
                   dp_axes: Sequence[str], context_parallel: bool
                   ) -> tuple[dict, dict]:
    """The train batch without ``labels``; every input replicated under
    ``context_parallel`` (a batch too small to split)."""
    out, split = train_inputs(arch, shape, dp_axes)
    del out["labels"], split["labels"]
    if context_parallel:
        split = {k: None for k in out}
    return out, split


def decode_inputs(arch: ArchConfig, shape: ShapeConfig,
                  dp_axes: Sequence[str], context_parallel: bool
                  ) -> tuple[dict, dict]:
    """One decode step: ``tokens`` ``(gb, 1)`` and ``cur_len`` ``(gb,)``
    int32, and for the vlm family ``mrope_positions`` ``(3, gb, 1)``."""
    gb = shape.global_batch
    dp = None if context_parallel or not tuple(dp_axes) else 0
    out = {"tokens": _meta((gb, 1), torch.int32),
           "cur_len": _meta((gb,), torch.int32)}
    split = {"tokens": dp, "cur_len": dp}
    if arch.family == "vlm":
        out["mrope_positions"] = _meta((3, gb, 1), torch.int32)
        split["mrope_positions"] = None if dp is None else 1
    return out, split


def vlm_positions(b: int, s: int, image: int = 64, grid: int = 8
                  ) -> torch.Tensor:
    """int64 ``(3, b, s)`` M-RoPE positions of a sequence that opens with
    an image of ``image`` patch tokens on a ``grid``-wide raster, then
    text (Qwen2-VL §3.1): over the image t is 0 and h, w walk the grid
    (``i // grid``, ``i % grid``); the text continues from the image's
    largest position plus one, equal in all three streams."""
    image = min(image, s)
    i = torch.arange(image)
    t = torch.zeros(image, dtype=torch.int64)
    h, w = i // grid, i % grid
    start = int(torch.stack([t, h, w]).max()) + 1 if image else 0
    text = torch.arange(start, start + s - image)
    rows = torch.stack([torch.cat([a, text]) for a in (t, h, w)])
    return rows[:, None, :].expand(3, b, s).contiguous()


def with_frontend_inputs(arch: ArchConfig, batch: dict, seed: int) -> dict:
    """``batch`` and the stubbed frontends' inputs for its rows: a
    standard normal ``(B, S, d_model)`` in fp32 from ``seed``, the vlm
    family's ``embeds`` (with the ``vlm_positions``) or the audio
    family's ``enc_embeds`` (the encoder as long as the decoder).  Other
    families' batches pass through.  Given a global batch and split
    after, the draw is the same at every mesh."""
    if arch.family not in ("vlm", "audio"):
        return batch
    b, s = batch["tokens"].shape
    gen = torch.Generator().manual_seed(seed)
    frames = torch.randn(b, s, arch.d_model, generator=gen)
    if arch.family == "audio":
        return {**batch, "enc_embeds": frames}
    return {**batch, "embeds": frames, "mrope_positions": vlm_positions(b, s)}
