"""Gradient bucketing — the PyTorch-DDP "25 MB bucket" mechanism (paper
§2.2).  Counterpart of ``repro.core.bucketing``, byte-based layouts only
(leaf-aligned layouts come with the overlapped schedule), and of its
ZeRO-1 owner sharding (``OwnerPlan``, ``owner_plan``): each bucket has one
owner rank, or, with fewer buckets than ranks, the largest buckets are
split so every rank owns one contiguous sub-bucket.

The gradient leaves are raveled, in the JAX package's leaf order, into one
flat vector that is split into fixed-byte buckets.  PowerSGD is not
invariant to element order, so the order is part of the contract: the
port's model lists its parameters in exactly that order (see
``repro_torch.models.model``).
"""
from __future__ import annotations

import dataclasses
import warnings
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


def read_flat(leaves: Sequence[torch.Tensor], start: int, out: torch.Tensor,
              dtype: Any) -> torch.Tensor:
    """Fill ``out`` with the flat range ``[start, start + len(out))`` of the
    leaves raveled in order and cast to ``dtype`` (then to ``out``'s
    dtype); zeros past the last element.  Copies leaf by leaf: the flat
    vector itself is never built."""
    end = start + out.shape[0]
    lo = 0
    for t in leaves:
        hi = lo + t.numel()
        a, b = max(lo, start), min(hi, end)
        if a < b:
            out[a - start:b - start].copy_(
                t.reshape(-1)[a - lo:b - lo].to(dtype))
        lo = hi
    if end > lo:
        out[max(lo, start) - start:].zero_()
    return out


def write_flat(leaves: Sequence[torch.Tensor], start: int,
               src: torch.Tensor) -> None:
    """In place: the flat range ``[start, start + len(src))`` of the leaves
    raveled in order <- ``src``, cast to each leaf's dtype."""
    end = start + src.shape[0]
    lo = 0
    for t in leaves:
        hi = lo + t.numel()
        a, b = max(lo, start), min(hi, end)
        if a < b:
            t.view(-1)[a - lo:b - lo].copy_(src[a - start:b - start])
        lo = hi


def from_buckets(buckets: Sequence[torch.Tensor],
                 leaves_like: Sequence[torch.Tensor],
                 layout: BucketLayout) -> list[torch.Tensor]:
    """Inverse of :func:`to_buckets` (shapes and dtypes from
    ``leaves_like``)."""
    flat = torch.cat([b.to(layout.dtype) for b in buckets])
    parts = flat.split([t.numel() for t in leaves_like])
    return [p.reshape(t.shape).to(t.dtype)
            for p, t in zip(parts, leaves_like)]


# --------------------------------------------------------------------------
# ZeRO-1 owner sharding: shard boundaries ARE bucket boundaries
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OwnerPlan:
    """Bucket-granular ZeRO-1 sharding over the DP ranks.

    With ``n_buckets >= n_ranks`` each bucket is owned by exactly ONE
    rank and a rank's optimizer shard is the concatenation of its owned
    buckets.  Ownership runs are contiguous in bucket order, so a rank's
    shard is one contiguous slice ``[starts[r], starts[r] + lengths[r])``
    of the flat bucket-concat space, of padded length ``cap`` on every
    rank.

    With ``n_buckets < n_ranks`` the largest buckets are SPLIT (at
    element midpoints, repeatedly) until one sub-bucket per rank exists;
    a split bucket then spans several owners and its gathered-space
    location is the multi-piece ``pieces[b]`` instead of a single
    ``param_offset``.
    """
    n_ranks: int
    owners: tuple[int, ...]           # bucket -> owner of its FIRST element
    starts: tuple[int, ...]           # rank -> flat start offset
    lengths: tuple[int, ...]          # rank -> owned element count
    bucket_offsets: tuple[int, ...]   # bucket -> flat start offset
    #: bucket -> ((gathered_offset, length), ...) pieces inside the
    #: (n_ranks · cap) gathered-shard space, in element order.  A bucket
    #: owned by one rank has exactly one piece (== ``param_offset``).
    pieces: tuple[tuple[tuple[int, int], ...], ...] = ()

    @property
    def cap(self) -> int:
        """Padded per-rank shard length (the per-rank state size)."""
        return max(self.lengths) if self.lengths else 0

    def param_offset(self, b: int) -> int:
        """Offset of bucket ``b`` inside the (p, cap) gathered-shard
        space.  Only defined for single-owner buckets — split buckets are
        located by ``pieces[b]``."""
        if len(self.pieces[b]) != 1:
            raise ValueError(f"bucket {b} is owner-split; use pieces[{b}]")
        return self.pieces[b][0][0]


def assign_owner_ranks(sizes: Sequence[int], n_ranks: int
                       ) -> tuple[int, ...]:
    """Contiguous balanced bucket -> owner-rank assignment: walk buckets
    in order, close the current rank's run once it holds >= total/n_ranks
    elements.  Owners are non-decreasing; trailing ranks may own nothing
    when there are fewer buckets than ranks."""
    total = sum(int(s) for s in sizes)
    target = -(-total // max(1, n_ranks))
    owners: list[int] = []
    rank, acc = 0, 0
    for s in sizes:
        if acc >= target and rank + 1 < n_ranks:
            rank += 1
            acc = 0
        owners.append(rank)
        acc += int(s)
    return tuple(owners)


def split_for_coverage(sizes: Sequence[int], n_ranks: int
                       ) -> list[tuple[int, int]]:
    """Sub-bucket list ``[(parent_bucket, size), ...]`` (flat order
    preserved) with the LARGEST buckets split at element midpoints until
    one sub-bucket per rank exists.  Stops early (still short of
    ``n_ranks``) only when every sub-bucket is a single element."""
    subs = [(b, int(s)) for b, s in enumerate(sizes)]
    while len(subs) < n_ranks:
        i = max(range(len(subs)), key=lambda j: subs[j][1])
        b, s = subs[i]
        if s < 2:
            break                      # fewer elements than ranks
        subs[i:i + 1] = [(b, s - s // 2), (b, s // 2)]
    return subs


def owner_plan(layout: BucketLayout, n_ranks: int) -> OwnerPlan:
    """The ZeRO-1 sharding plan for a bucket layout: bucket-granular while
    ``n_buckets >= n_ranks``; with fewer buckets than ranks the largest
    are split (``split_for_coverage``) so every rank owns one contiguous
    sub-bucket.  Warns, as the JAX package does, when the plan is
    degenerate or its largest shard exceeds twice the ideal n/p."""
    bucket_offsets, off = [], 0
    for s in layout.sizes:
        bucket_offsets.append(off)
        off += int(s)
    if layout.n_buckets >= n_ranks:
        owners = assign_owner_ranks(layout.sizes, n_ranks)
        subs = [(b, int(layout.sizes[b])) for b in range(layout.n_buckets)]
        sub_owner = list(owners)
    else:
        subs = split_for_coverage(layout.sizes, n_ranks)
        sub_owner = list(range(len(subs)))
        if len(subs) < n_ranks:
            warnings.warn(
                f"ZeRO-1 owner sharding is degenerate even after bucket "
                f"splitting: {layout.n_elements} element(s) over "
                f"{n_ranks} DP ranks — trailing ranks own nothing.",
                stacklevel=2)
        owners = []
        i = 0
        for b in range(layout.n_buckets):
            owners.append(sub_owner[i])
            while i < len(subs) and subs[i][0] == b:
                i += 1
        owners = tuple(owners)
    starts, lengths = [], []
    sub_off, sub_flat = [], 0
    for _, s in subs:
        sub_off.append(sub_flat)
        sub_flat += s
    for r in range(n_ranks):
        owned = [i for i in range(len(subs)) if sub_owner[i] == r]
        starts.append(sub_off[owned[0]] if owned
                      else (starts[-1] + lengths[-1] if starts else 0))
        lengths.append(sum(subs[i][1] for i in owned))
    cap = max(lengths) if lengths else 0
    ideal = -(-layout.n_elements // max(1, n_ranks))
    if n_ranks > 1 and cap > 2 * ideal:
        warnings.warn(
            f"ZeRO-1 owner sharding is imbalanced: the largest rank "
            f"shard is {cap} elements vs the ideal {ideal} (n/p).  "
            f"Per-rank state is cap-padded, so the param gather (and "
            f"the reduce_to_owner_broadcast reduce-scatter) moves "
            f"p·cap elements, not n — lower bucket_mb so buckets pack "
            f"evenly across ranks.", stacklevel=2)
    # bucket -> gathered-space pieces (merge adjacent same-owner subs)
    pieces: list[list[list[int]]] = [[] for _ in range(layout.n_buckets)]
    for i, (b, s) in enumerate(subs):
        if not s:
            continue
        r = sub_owner[i]
        g_off = r * cap + sub_off[i] - starts[r]
        ps = pieces[b]
        if ps and ps[-1][0] + ps[-1][1] == g_off:
            ps[-1][1] += s
        else:
            ps.append([g_off, s])
    # zero-size buckets still need one (empty) piece at their offset
    for b in range(layout.n_buckets):
        if not pieces[b]:
            r = owners[b]
            pieces[b].append([r * cap + bucket_offsets[b] - starts[r], 0])
    return OwnerPlan(n_ranks, tuple(owners), tuple(starts), tuple(lengths),
                     tuple(bucket_offsets),
                     tuple(tuple((int(o), int(ln)) for o, ln in ps)
                           for ps in pieces))
