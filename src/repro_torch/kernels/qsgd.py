"""QSGD stochastic quantization: a CUDA kernel for Hopper and its plain
version.

Replaces the Pallas kernel ``repro/kernels/qsgd.py::quantize`` (source:
``csrc/qsgd.cu``).

  quantize  g (n,) fp32, norm () fp32, u (n,) fp32 -> (n,) int8 in
            [-levels, levels]: sign(g) * (floor(s) + [u < s - floor(s)]),
            s = |g| / norm * levels

The kernel equals ``ref.qsgd_quantize`` bit for bit: it keeps that order of
operations, ``|g| / norm`` then ``* levels``.  The Pallas kernel scales by
a precomputed ``levels / (norm + 1e-12)`` instead, which rounds
differently and can flip a carry; the port follows the JAX oracle, which
the JAX package's CPU path runs.

Bound on an H100: device-memory bytes, 9 per element (g and u read, q
written).  At the main path's bucket of 6,553,600 elements that is 58.98
MB, at least 17.6 us at 3.35 TB/s.

Design: one thread per element, grid-strided, coalesced.  ``norm`` stays on
the card and the kernel reads it through a pointer, so quantizing a bucket
costs no host-device synchronisation.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import qsgd_quantize as plain_quantize  # noqa: F401


def quantize(g: torch.Tensor, norm: torch.Tensor, levels: int,
             u: torch.Tensor) -> torch.Tensor:
    build.check_cuda_fp32("g", g)
    build.check_cuda_fp32("u", u)
    build.check_cuda_fp32("norm", norm, dim=0)
    if u.shape != g.shape or u.device != g.device or norm.device != g.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device}, u "
                         f"{tuple(u.shape)} on {u.device} and norm on "
                         f"{norm.device} do not match")
    if not 1 <= levels <= 127:
        raise ValueError(f"levels must be in [1, 127], got {levels}")
    n = g.shape[0]
    out = torch.empty((n,), dtype=torch.int8, device=g.device)
    with torch.cuda.device(g.device):
        err = build.lib().rt_qsgd_quantize(
            g.data_ptr(), u.data_ptr(), norm.data_ptr(), levels, n,
            out.data_ptr(), build.stream_of(g))
    build.check(err, "qsgd_quantize")
    build.LAUNCHES["qsgd_quantize"] += 1
    return out
