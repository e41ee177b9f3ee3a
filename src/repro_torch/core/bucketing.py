"""Gradient bucketing — the PyTorch-DDP "25 MB bucket" mechanism (paper
§2.2).  Counterpart of ``repro.core.bucketing``, byte-based layouts only
(leaf-aligned layouts come with the overlapped schedule).

The gradient leaves are raveled, in the JAX package's leaf order, into one
flat vector that is split into fixed-byte buckets.  PowerSGD is not
invariant to element order, so the order is part of the contract: the
port's model lists its parameters in exactly that order (see
``repro_torch.models.model``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static description of how the leaves map onto buckets."""
    n_elements: int            # total (unpadded) element count
    bucket_elems: int          # elements per full bucket (byte target)
    n_buckets: int
    dtype: Any
    sizes: tuple[int, ...]     # per-bucket element counts (last may be short)

    @property
    def last_elems(self) -> int:
        return self.sizes[-1]


def _majority_dtype(leaves: Sequence[torch.Tensor]):
    """Bucket dtype = the dtype holding the most bytes."""
    by_dtype: dict = {}
    for t in leaves:
        by_dtype[t.dtype] = by_dtype.get(t.dtype, 0) \
            + t.numel() * t.element_size()
    return max(by_dtype, key=by_dtype.get)


def layout_for(leaves: Sequence[torch.Tensor],
               bucket_mb: float) -> BucketLayout:
    """Byte-based layout over ``leaves`` (any tensors with the gradients'
    shapes and dtypes, in leaf order)."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("empty gradient list")
    dtype = _majority_dtype(leaves)
    n = sum(t.numel() for t in leaves)
    itemsize = torch.empty((), dtype=dtype).element_size()
    bucket_elems = max(1, int(bucket_mb * 2**20) // itemsize)
    n_buckets = -(-n // bucket_elems)
    sizes = [bucket_elems] * (n_buckets - 1)
    sizes.append(n - bucket_elems * (n_buckets - 1))
    return BucketLayout(n, bucket_elems, n_buckets, dtype, tuple(sizes))


def to_buckets(leaves: Sequence[torch.Tensor],
               layout: BucketLayout) -> list[torch.Tensor]:
    """Ravel the leaves into their list of 1-D buckets (views of one flat
    concatenation, cast to the bucket dtype)."""
    flat = torch.cat([t.reshape(-1).to(layout.dtype) for t in leaves])
    if flat.shape[0] != layout.n_elements:
        raise ValueError(f"{flat.shape[0]} elements for a layout of "
                         f"{layout.n_elements}")
    return list(flat.split(list(layout.sizes)))


def from_buckets(buckets: Sequence[torch.Tensor],
                 leaves_like: Sequence[torch.Tensor],
                 layout: BucketLayout) -> list[torch.Tensor]:
    """Inverse of :func:`to_buckets` (shapes and dtypes from
    ``leaves_like``)."""
    flat = torch.cat([b.to(layout.dtype) for b in buckets])
    parts = flat.split([t.numel() for t in leaves_like])
    return [p.reshape(t.shape).to(t.dtype)
            for p, t in zip(parts, leaves_like)]
