"""PowerSGD encode/decode: CUDA kernels for Hopper and their plain versions.

Replaces the Pallas kernels ``repro/kernels/powersgd.py::encode`` and
``::decode`` (source: ``csrc/powersgd.cu``).

  encode  P = M @ Q    (rows x cols) @ (cols x r) -> (rows x r) fp32
  decode  M^ = P @ Q^T (rows x r) @ (r x cols)    -> (rows x cols) fp32

Bound on an H100: device-memory bytes.  With r <= 16 each element of the
big matrix meets at most 16 multiply-adds, about two flops per byte, far
below the card's balance point; at the main path's 2560 x 2560 fp32 bucket
matrix either kernel moves about 26.3 MB, at least 7.8 us at 3.35 TB/s.

Design: the big matrix is streamed once with coalesced loads (or stores)
and the r-wide factor rows stay in registers; ``encode`` reads ``m`` by its
strides, so PowerSGD's second round ``M^T @ P^`` runs on the transposed
view without a copy (see the source for both access patterns).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import powersgd_decode as plain_decode  # noqa: F401
from repro_torch.kernels.ref import powersgd_encode as plain_encode  # noqa: F401

MAX_RANK = 16


def _require_cuda_fp32(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")


def _check_rank(r: int) -> None:
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside 1..{MAX_RANK}")


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
    s_a, s_b = m.stride()
    if n_b == 1:
        s_b = 1
    elif n_a == 1:
        s_a = 1
    if s_b != 1 and s_a != 1:
        raise ValueError(f"m needs a unit stride along one dim, got strides "
                         f"{m.stride()}")
    out = torch.empty((n_a, r), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        splits, scratch = 1, out
        if s_b != 1:
            n = ctypes.c_int()
            build.check(build.lib().rt_powersgd_encode_splits(
                n_a, n_b, ctypes.byref(n)), "powersgd_encode")
            splits = n.value
            if splits > 1:
                scratch = torch.empty((splits, n_a, r), dtype=torch.float32,
                                      device=m.device)
        err = build.lib().rt_powersgd_encode(
            m.data_ptr(), n_a, n_b, s_a, s_b, q.data_ptr(), r, out.data_ptr(),
            scratch.data_ptr(), splits, build.stream_of(m))
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
    out = torch.empty((rows, cols), dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        err = build.lib().rt_powersgd_decode(
            p.data_ptr(), q.data_ptr(), rows, cols, r, out.data_ptr(),
            build.stream_of(p))
    build.check(err, "powersgd_decode")
    build.LAUNCHES["powersgd_decode"] += 1
    return out
