"""Plain PyTorch versions of every kernel on the port's path.

They define the semantics: the CPU path (tests, the ``meta``-device wire
accounting) runs them directly, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  Counterpart of ``repro.kernels.ref``.

Packed sign words are carried as ``int32`` tensors (4 bytes per word, the
same wire size as ``uint32``): PyTorch on the CPU has no shifts or sums for
``torch.uint32``, so the bit work runs in ``int64`` and only the storage is
32-bit.  Reinterpret with ``.view(torch.uint32)`` / ``.view(np.uint32)``
where a caller needs the unsigned words.
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------- powersgd
def powersgd_encode(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = M @ Q  (tall-skinny: rank << cols), fp32 accumulation."""
    return m.float() @ q.float()


def powersgd_decode(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """M^ = P @ Q^T."""
    return p.float() @ q.float().T


# ---------------------------------------------------------------- bitpack
def _to_int32_words(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_signs(g: torch.Tensor) -> torch.Tensor:
    """Pack sign bits (g >= 0 -> 1) into 32-bit words, little-endian bit
    order.  The length is padded to a multiple of 32 with 0 bits.  -0.0
    packs as 1 and NaN as 0, as ``g >= 0`` says."""
    n = g.shape[0]
    words = -(-n // 32)
    bits = (g >= 0).to(torch.int64)
    bits = torch.nn.functional.pad(bits, (0, words * 32 - n)).reshape(words, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=g.device)
    return _to_int32_words((bits << shifts).sum(dim=1))


def unpack_signs(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_signs``: the {0, 1} int32 vector of length n."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].to(torch.int32)


def popcount_votes(gathered: torch.Tensor, n: int) -> torch.Tensor:
    """gathered: (p, words) packed bitmaps -> (n,) int32 count of positive
    votes per element: a sum over the p rows, not a popcount within a word.
    (Sign extension to int64 keeps bits 0..31 of each word unchanged.)"""
    shifts = torch.arange(32, dtype=torch.int64, device=gathered.device)
    bits = (gathered.to(torch.int64)[:, :, None] >> shifts) & 1
    return bits.sum(dim=0).reshape(-1)[:n].to(torch.int32)


# ---------------------------------------------------------------- top-k
def topk_select(g: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by magnitude: (signed values, int32 indices), largest
    magnitude first."""
    _, idx = torch.topk(g.abs(), k)
    return g[idx], idx.to(torch.int32)


def topk_threshold_mask(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """|g| >= t ? g : 0.  NaN masks to 0; -0.0 is kept when t <= 0."""
    return torch.where(g.abs() >= t, g, torch.zeros_like(g))


def sampled_threshold(g: torch.Tensor, k: int,
                      generator: "torch.Generator | None" = None,
                      sample: int = 4096) -> torch.Tensor:
    """Estimate the |g| threshold that keeps about k elements from the
    (1 - k/n) quantile of ``sample`` magnitudes drawn with replacement
    (the 'multi-stage' trick of MSTop-K: no full sort)."""
    n = g.shape[0]
    idx = torch.randint(0, n, (min(sample, n),), generator=generator,
                        device=g.device)
    return torch.quantile(g[idx].abs(), 1.0 - k / n)


# ---------------------------------------------------------------- qsgd
def qsgd_quantize(g: torch.Tensor, norm: torch.Tensor, levels: int,
                  u: torch.Tensor) -> torch.Tensor:
    """Stochastic uniform quantization to int8 levels in [-levels, levels]:
    sign(g) * (floor(s) + [u < s - floor(s)]) with s = |g| / norm * levels,
    in that order of operations (the JAX oracle's).  ``u`` is the uniform
    draw in [0, 1), one per element; E[q * norm / levels] = g."""
    scaled = g.abs() / norm * levels
    low = torch.floor(scaled)
    up = (u < scaled - low).to(torch.float32)
    return (torch.sign(g) * (low + up)).to(torch.int8)
