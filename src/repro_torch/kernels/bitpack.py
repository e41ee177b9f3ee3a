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
26.2 MB, so at p <= 4 the 4-byte counts are the bound (8.1-8.8 us).

Design: pack builds each word with one warp ballot over 32 coalesced
loads.  The vote count gives a warp groups of 32 words (1024 elements):
it issues the loads of two groups and four rows at a time before any
arithmetic, keeps each count in bit slices (bit_length(p) planes, a row
added with O(bit_length(p)) bit operations per 32 elements), and writes
each group's 4 KB of counts with 16-byte stores, scalar ones only at the
ragged end (see the source).  ``votes_plan`` sizes its grid from the SM
count.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pack_signs as plain_pack_signs  # noqa: F401
from repro_torch.kernels.ref import popcount_votes as plain_popcount_votes  # noqa: F401,E501

#: the launch shape csrc/bitpack.cu's votes_kernel is built with (it
#: refuses a plan whose plane count is not its own)
VOTES_THREADS = 256       # threads per block
VOTES_GROUPS = 2          # groups of 32 words a warp loads together
VOTES_BLOCKS_PER_SM = 4   # resident blocks per SM the grid is cut to
MAX_PLANES = 8            # bit slices at most: p > 255 counts in chunks
GROUP_ELEMS = 32 * 32     # elements of one group of 32 words
MAX_N = 2**31 - 1         # the kernel indexes elements with 32 bits


class VotesPlan(NamedTuple):
    """What the wrapper launches: ``blocks`` of VOTES_THREADS, each warp
    taking ``per_warp`` of the ``groups`` word groups per step (one, in
    chunks of 255 rows, where ``wide``), ``planes`` bit slices; the first
    ``vec_elems`` counts are written with 16-byte stores, the last
    ``scalar_elems`` one by one."""
    blocks: int
    planes: int
    wide: bool
    groups: int
    per_warp: int
    vec_elems: int
    scalar_elems: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def votes_plan(p: int, words: int, n: int, sms: int) -> VotesPlan:
    """The vote-count launch for ``p`` rows of ``words`` words and ``n``
    counts on a card of ``sms`` SMs.  Raises ValueError on what the kernel
    does not take."""
    if p < 1 or not 0 <= n <= 32 * words:
        raise ValueError(f"n={n} does not fit {words} words of {p} rows")
    if n > MAX_N:
        raise ValueError(f"n={n} is not below 2**31: the kernel indexes "
                         f"elements with 32 bits")
    wide = p >= 2**MAX_PLANES
    per_warp = 1 if wide else VOTES_GROUPS
    groups = _cdiv(n, GROUP_ELEMS)
    warps = _cdiv(groups, per_warp)
    blocks = max(1, min(_cdiv(warps, VOTES_THREADS // 32),
                        VOTES_BLOCKS_PER_SM * sms))
    return VotesPlan(blocks, min(p.bit_length(), MAX_PLANES), wide, groups,
                     per_warp, n - n % 4, n % 4)


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
    plan = votes_plan(p, words, n, build.sms(gathered.device))
    out = torch.empty((n,), dtype=torch.int32, device=gathered.device)
    with torch.cuda.device(gathered.device):
        err = build.lib().rt_popcount_votes(
            gathered.data_ptr(), p, words, n, out.data_ptr(), plan.planes,
            plan.blocks, build.stream_of(gathered))
    build.check(err, "popcount_votes")
    build.LAUNCHES["popcount_votes"] += 1
    return out
