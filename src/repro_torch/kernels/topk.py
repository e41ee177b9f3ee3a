"""MSTop-K threshold masking: a CUDA kernel for Hopper and its plain
version.

Replaces the Pallas kernel ``repro/kernels/topk.py::threshold_mask``
(source: ``csrc/topk.cu``).

  threshold_mask  g (n,) fp32, t () fp32 -> (n,) fp32, |g| >= t ? g : 0

As in the JAX package, no compressor calls it: MSTop-K selects with the
exact ``ref.topk_select``, and this op is reached only through
``ops.topk_threshold_mask``.

Bound on an H100: device-memory bytes, 8 per element.  At 6,553,600
elements that is 52.4 MB, at least 15.6 us at 3.35 TB/s.

Design: one thread per element, grid-strided, coalesced; ``t`` stays on
the card and the kernel reads it through a pointer.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import topk_threshold_mask as plain_threshold_mask  # noqa: F401,E501


def threshold_mask(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    build.check_cuda_fp32("g", g)
    build.check_cuda_fp32("t", t, dim=0)
    if t.device != g.device:
        raise ValueError(f"g on {g.device} and t on {t.device} differ")
    n = g.shape[0]
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        err = build.lib().rt_topk_threshold_mask(
            g.data_ptr(), t.data_ptr(), n, out.data_ptr(), build.stream_of(g))
    build.check(err, "threshold_mask")
    build.LAUNCHES["threshold_mask"] += 1
    return out
