"""Device-dispatching entry points for the port's kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
any other tensor (the CPU, or ``meta`` for shape-only wire accounting)
goes to the plain version in ``ref.py``.  There is no switch that sends a
CUDA tensor to the plain version.  Counterpart of ``repro.kernels.ops``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def powersgd_encode(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if _on_cuda(m):
        from repro_torch.kernels import powersgd
        return powersgd.encode(m, q)
    return ref.powersgd_encode(m, q)


def powersgd_decode(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if _on_cuda(p):
        from repro_torch.kernels import powersgd
        return powersgd.decode(p, q)
    return ref.powersgd_decode(p, q)


def pack_signs(g: torch.Tensor) -> torch.Tensor:
    if _on_cuda(g):
        from repro_torch.kernels import bitpack
        return bitpack.pack_signs(g)
    return ref.pack_signs(g)


def popcount_votes(gathered: torch.Tensor, n: int) -> torch.Tensor:
    if _on_cuda(gathered):
        from repro_torch.kernels import bitpack
        return bitpack.popcount_votes(gathered, n)
    return ref.popcount_votes(gathered, n)


def qsgd_quantize(g: torch.Tensor, norm: torch.Tensor, levels: int,
                  u: torch.Tensor) -> torch.Tensor:
    if _on_cuda(g):
        from repro_torch.kernels import qsgd
        return qsgd.quantize(g, norm, levels, u)
    return ref.qsgd_quantize(g, norm, levels, u)


def topk_threshold_mask(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    if _on_cuda(g):
        from repro_torch.kernels import topk
        return topk.threshold_mask(g, t)
    return ref.topk_threshold_mask(g, t)


def topk_select(g: torch.Tensor, k: int):
    """Exact selection on every device, as in the JAX package: the
    threshold-and-mask path is a separate op because its contract
    (about k elements) differs."""
    return ref.topk_select(g, k)
