"""PowerSGD encode/decode: CUDA kernels for Hopper and their plain versions.

Replaces the Pallas kernels ``repro/kernels/powersgd.py::encode`` and
``::decode`` (source: ``csrc/powersgd.cu``).

  encode  P = M @ Q    (rows x cols) @ (cols x r) -> (rows x r) fp32
  decode  M^ = P @ Q^T (rows x r) @ (r x cols)    -> (rows x cols) fp32

Bound on an H100: device-memory bytes.  With r <= 16 each element of the
big matrix meets at most 16 multiply-adds, about two flops per byte, far
below the card's balance point; at the main path's 2560 x 2560 fp32 bucket
matrix either kernel moves about 26.3 MB, at least 7.8 us at 3.35 TB/s.

Design: the big matrix is streamed once with 16-byte loads (or stores)
and the r-wide factor rows stay in registers or are read from L1; ``encode``
reads ``m`` by its strides, so PowerSGD's second round ``M^T @ P^`` runs on
the transposed view without a copy.  ``encode_plan`` and ``decode_plan``
choose the kernel's variant and grid from shapes and strides alone (see
the source for both access patterns): the grid is cut along the reduction
dimension too, so that it fills every SM, and the splits' partial sums
meet in a fixed order, so the result is the same bits on every launch.
The arrival counters that order them are kept per device and stream:
encodes on one stream run in order and share them, encodes on two
streams may overlap and each has its own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import powersgd_decode as plain_decode  # noqa: F401
from repro_torch.kernels.ref import powersgd_encode as plain_encode  # noqa: F401

MAX_RANK = 16
#: the block shapes csrc/powersgd.cu is built with (it refuses a plan whose
#: tile count is not its own)
ROWS_THREADS = 128    # encode_rows: threads per block
ROWS_PER_WARP = 4     # encode_rows: rows of m per warp
ROWS_STEP = 512       # encode_rows: columns a warp covers per unrolled step
COLS_THREADS = 256    # encode_cols: threads per block
DECODE_THREADS = 128  # decode: threads per block
DECODE_CWARPS = 4     # decode: warps side by side across a tile's columns
#: warps per SM that a split plan aims for before it cuts the reduction
#: dimension (these and the block sizes were chosen on an H100, PERF.md)
WARPS_PER_SM = 16


class Plan(NamedTuple):
    """What the wrapper launches: ``form`` "rows" (``encode_rows``, m's
    rows contiguous), "cols" (``encode_cols``, m's columns contiguous) or
    "decode"; ``vec`` 4 for 16-byte accesses of the big matrix, 1 for
    scalar ones; ``xvec`` 4 to read the skinny factor's rows as float4;
    ``tiles`` blocks along the output (across its columns, for decode);
    ``splits`` blocks along the reduction dimension (the output rows, for
    decode), each over ``per`` of its elements."""
    form: str
    vec: int
    xvec: int
    tiles: int
    splits: int
    per: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(n: int, tiles: int, threads: int, gran: int, sms: int
           ) -> tuple[int, int]:
    """(splits, per): about enough blocks along ``n`` that ``tiles`` x
    splits blocks of ``threads`` give WARPS_PER_SM on each of ``sms`` SMs,
    ``per`` a multiple of ``gran``, no split empty."""
    warps = threads // 32
    want = max(1, _cdiv(WARPS_PER_SM * sms, max(tiles, 1) * warps))
    per = _cdiv(_cdiv(max(n, 1), want), gran) * gran
    return max(1, _cdiv(n, per)), per


def _xvec(rank: int, offset: int) -> int:
    return 4 if rank % 4 == 0 and offset % 4 == 0 else 1


def encode_plan(shape: tuple[int, int], strides: tuple[int, int],
                offset: int, rank: int, sms: int, x_offset: int = 0) -> Plan:
    """The encode launch for an (n_a, n_b) fp32 ``m`` of these strides
    whose first element lies ``offset`` elements past a 16-byte boundary
    (its storage offset, for the caching allocator's storage), times a
    contiguous (n_b, rank) factor ``x_offset`` elements past one, on a
    card of ``sms`` SMs.  Raises on what no kernel takes."""
    _check_rank(rank)
    n_a, n_b = shape
    s_a, s_b = _unit_strides(shape, strides)
    aligned = offset % 4 == 0
    xvec = _xvec(rank, x_offset)
    if s_b == 1:                       # M @ Q: walk along m's rows
        vec = 4 if aligned and n_b % 4 == 0 and (n_a == 1 or s_a % 4 == 0) \
            else 1
        tiles = _cdiv(n_a, ROWS_THREADS // 32 * ROWS_PER_WARP)
        splits, per = _split(n_b, tiles, ROWS_THREADS, ROWS_STEP, sms)
        return Plan("rows", vec, xvec, tiles, splits, per)
    vec = 4 if aligned and n_a % 4 == 0 and (n_b == 1 or s_b % 4 == 0) \
        else 1                         # M^T @ P: walk down m's columns
    tiles = _cdiv(n_a, 32 * vec)
    splits, per = _split(n_b, tiles, COLS_THREADS, 1, sms)
    return Plan("cols", vec, xvec, tiles, splits, per)


def decode_plan(rows: int, cols: int, rank: int, sms: int,
                p_offset: int = 0) -> Plan:
    """The decode launch for a (rows x cols) output at rank ``rank`` whose
    contiguous factors lie ``p_offset`` elements past a 16-byte boundary
    (0 only if both P and Q are aligned): 16-byte stores where ``cols`` is
    a multiple of 4, the rows cut into ``splits`` ranges of ``per``."""
    _check_rank(rank)
    vec = 4 if cols % 4 == 0 else 1
    tiles = _cdiv(cols, 32 * vec * DECODE_CWARPS)
    splits, per = _split(rows, tiles, DECODE_THREADS, 1, sms)
    return Plan("decode", vec, _xvec(rank, p_offset), tiles, splits, per)


def _check_rank(r: int) -> None:
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside 1..{MAX_RANK}")


def _unit_strides(shape, strides) -> tuple[int, int]:
    """m's strides with a size-1 dim's stride taken as 1; raises unless
    one dim has a unit stride."""
    (n_a, n_b), (s_a, s_b) = shape, strides
    if n_b == 1:
        s_b = 1
    elif n_a == 1:
        s_a = 1
    if s_b != 1 and s_a != 1:
        raise ValueError(f"m needs a unit stride along one dim, got strides "
                         f"{tuple(strides)}")
    return s_a, s_b


def _require_cuda_fp32(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")


def _offset(t: torch.Tensor) -> int:
    """Elements from the last 16-byte boundary to ``t``'s first element."""
    return t.data_ptr() // 4 % 4


_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _counters_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed arrival counters for the launches on
    ``stream`` of ``device``; every launch leaves the counters it used at
    zero, so the next launch on that stream finds them so, while a launch
    on another stream, which may run at the same time, uses its own."""
    c = _counters.get((device, stream))
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[(device, stream)] = c
    return c


def encode(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = M @ Q on the card.  ``m`` may be any view with a unit stride
    along one of its dims (row-major, or a transposed row-major matrix)."""
    _require_cuda_fp32("m", m)
    _require_cuda_fp32("q", q)
    n_a, n_b = m.shape
    r = q.shape[1]
    _check_rank(r)
    if q.shape[0] != n_b or not q.is_contiguous() or q.device != m.device:
        raise ValueError(f"q must be a contiguous ({n_b}, r) tensor on "
                         f"{m.device}, got {tuple(q.shape)} on {q.device}")
    s_a, s_b = _unit_strides(m.shape, m.stride())
    plan = encode_plan((n_a, n_b), m.stride(), _offset(m), r,
                       build.sms(m.device), _offset(q))
    stream = build.stream_of(m)
    out = torch.empty((n_a, r), dtype=torch.float32, device=m.device)
    scratch = counters = None
    if plan.splits > 1:
        scratch = torch.empty((plan.splits, n_a, r), dtype=torch.float32,
                              device=m.device)
        counters = _counters_for(m.device, stream, plan.tiles)
    with torch.cuda.device(m.device):
        err = build.lib().rt_powersgd_encode(
            m.data_ptr(), n_a, n_b, s_a, s_b, q.data_ptr(), r, out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            counters.data_ptr() if counters is not None else None,
            counters.numel() if counters is not None else 0,
            int(plan.form == "cols"), plan.vec, plan.xvec, plan.tiles,
            plan.splits, plan.per, stream)
    build.check(err, "powersgd_encode")
    build.LAUNCHES["powersgd_encode"] += 1
    return out


def decode(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """M^ = P @ Q^T on the card."""
    _require_cuda_fp32("p", p)
    _require_cuda_fp32("q", q)
    rows, r = p.shape
    cols = q.shape[0]
    _check_rank(r)
    if q.shape[1] != r or q.device != p.device:
        raise ValueError(f"q must be (cols, {r}) on {p.device}, got "
                         f"{tuple(q.shape)} on {q.device}")
    if not (p.is_contiguous() and q.is_contiguous()):
        raise ValueError("p and q must be contiguous")
    plan = decode_plan(rows, cols, r, build.sms(p.device),
                       _offset(p) or _offset(q))
    out = torch.empty((rows, cols), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        err = build.lib().rt_powersgd_decode(
            p.data_ptr(), q.data_ptr(), rows, cols, r, out.data_ptr(),
            plan.vec, plan.xvec, plan.tiles, plan.splits, plan.per,
            build.stream_of(p))
    build.check(err, "powersgd_decode")
    build.LAUNCHES["powersgd_decode"] += 1
    return out
