"""SignSGD sign packing and vote counting: CUDA kernels for Hopper and their
plain versions.

Replaces the Pallas kernels ``repro/kernels/bitpack.py::pack_signs`` and
``::popcount_votes`` (source: ``csrc/bitpack.cu``).

  pack_signs      (n,) fp32 -> (ceil(n/32),) 32-bit words, bit i of word w
                  = g[32w + i] >= 0, pad bits 0
  popcount_votes  (p, words) words -> (n,) int32, per element the number of
                  the p rows whose bit is set

Words are carried as ``int32`` tensors with the bits of the ``uint32``
words of the reference (see ``ref.py``).

Bound on an H100: device-memory bytes.  At the main path's bucket of
6,553,600 elements, pack reads 26.2 MB and writes 0.8 MB (at least 8.1 us
at 3.35 TB/s); the vote count at p rows reads p x 0.8 MB and writes
26.2 MB.

Design: pack builds each word with one warp ballot over 32 coalesced
loads; the vote count gives each thread one element and lets the warp's
32 threads share one broadcast word load per row (see the source).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pack_signs as plain_pack_signs  # noqa: F401
from repro_torch.kernels.ref import popcount_votes as plain_popcount_votes  # noqa: F401,E501


def pack_signs(g: torch.Tensor) -> torch.Tensor:
    build.check_cuda_fp32("g", g)
    n = g.shape[0]
    out = torch.empty((-(-n // 32),), dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        err = build.lib().rt_pack_signs(g.data_ptr(), n, out.data_ptr(),
                                        build.stream_of(g))
    build.check(err, "pack_signs")
    build.LAUNCHES["pack_signs"] += 1
    return out


def popcount_votes(gathered: torch.Tensor, n: int) -> torch.Tensor:
    if gathered.device.type != "cuda":
        raise ValueError(f"gathered must be a CUDA tensor, got "
                         f"{gathered.device}")
    if gathered.dtype != torch.int32:
        raise TypeError(f"gathered must hold int32 words, got "
                        f"{gathered.dtype}")
    if gathered.dim() != 2 or not gathered.is_contiguous():
        raise ValueError(f"gathered must be contiguous (p, words), got "
                         f"shape {tuple(gathered.shape)}")
    p, words = gathered.shape
    if p < 1 or not 0 <= n <= 32 * words:
        raise ValueError(f"n={n} does not fit {words} words of {p} rows")
    out = torch.empty((n,), dtype=torch.int32, device=gathered.device)
    with torch.cuda.device(gathered.device):
        err = build.lib().rt_popcount_votes(
            gathered.data_ptr(), p, words, n, out.data_ptr(),
            build.stream_of(gathered))
    build.check(err, "popcount_votes")
    build.LAUNCHES["popcount_votes"] += 1
    return out
