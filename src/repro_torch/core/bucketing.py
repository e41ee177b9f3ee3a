"""Gradient bucketing — the PyTorch-DDP "25 MB bucket" mechanism (paper
§2.2).  Counterpart of ``repro.core.bucketing``: both layout families and
the ZeRO-1 owner sharding (``OwnerPlan``, ``owner_plan``): each bucket has
one owner rank, or, with fewer buckets than ranks, the largest buckets are
split so every rank owns one contiguous sub-bucket.

``layout_for(leaves, bucket_mb)``
    Byte-based boundaries: the gradient leaves are raveled, in the JAX
    package's leaf order, into one flat vector that is split into
    fixed-byte buckets (the classic step).  PowerSGD is not invariant to
    element order, so the order is part of the contract: the port's model
    lists its parameters in exactly that order (see
    ``repro_torch.models.model``).

``layout_for(leaves, bucket_mb, leaf_aligned=True)``
    PyTorch-DDP-style leaf-aligned boundaries: buckets are greedy runs of
    whole leaves, closed when the byte target is reached, with a recorded
    leaf -> bucket map (``leaf_bucket``).  No leaf straddles a boundary,
    so a bucket is complete the moment its layers' gradients are: what the
    overlapped step (``repro_torch.train.overlap``) needs to issue a
    bucket while earlier layers' backward still runs.
    ``leaves_to_buckets`` builds each bucket from its own leaves only.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static description of how the leaves map onto buckets."""
    n_elements: int            # total (unpadded) element count
    bucket_elems: int          # elements per full bucket (byte target)
    n_buckets: int
    dtype: Any
    sizes: tuple[int, ...]     # per-bucket element counts (last may be short)
    # leaf-aligned layouts only (None => byte-based boundaries):
    leaf_sizes: Optional[tuple[int, ...]] = None   # per-leaf element counts
    leaf_bucket: Optional[tuple[int, ...]] = None  # leaf index -> bucket

    @property
    def last_elems(self) -> int:
        return self.sizes[-1]

    @property
    def leaf_aligned(self) -> bool:
        return self.leaf_sizes is not None

    def bucket_leaves(self, b: int) -> tuple[int, int]:
        """Half-open leaf-index range [lo, hi) owned by bucket ``b``
        (leaf-aligned layouts only; buckets own contiguous leaf runs)."""
        if self.leaf_bucket is None:
            raise ValueError("bucket_leaves needs a leaf-aligned layout")
        lo = self.leaf_bucket.index(b)
        hi = lo
        while hi < len(self.leaf_bucket) and self.leaf_bucket[hi] == b:
            hi += 1
        return lo, hi


def _majority_dtype(leaves: Sequence[torch.Tensor]):
    """Bucket dtype = the dtype holding the most bytes."""
    by_dtype: dict = {}
    for t in leaves:
        by_dtype[t.dtype] = by_dtype.get(t.dtype, 0) \
            + t.numel() * t.element_size()
    return max(by_dtype, key=by_dtype.get)


def _bucket_elems(dtype, bucket_mb: float) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(1, int(bucket_mb * 2**20) // itemsize)


def leaf_aligned_sizes(leaf_sizes: Sequence[int], bucket_elems: int
                       ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Greedy leaf -> bucket assignment: walk the leaves in order, close
    the current bucket once it holds >= ``bucket_elems`` elements.  Every
    bucket owns at least one whole leaf and no leaf straddles a boundary,
    so a leaf bigger than the target joins the open bucket whole (which
    then closes oversized).

    Returns (per-bucket element counts, leaf index -> bucket index)."""
    sizes: list[int] = []
    leaf_bucket: list[int] = []
    acc = 0
    for s in leaf_sizes:
        if acc >= bucket_elems and acc > 0:
            sizes.append(acc)
            acc = 0
        leaf_bucket.append(len(sizes))
        acc += int(s)
    # close the open bucket whenever a leaf was assigned to it: even a
    # zero-size trailing leaf must land in a bucket that exists
    if (leaf_bucket and leaf_bucket[-1] == len(sizes)) or not sizes:
        sizes.append(acc)
    return tuple(sizes), tuple(leaf_bucket)


def layout_from_leaf_sizes(leaf_sizes: Sequence[int], dtype,
                           bucket_mb: float) -> BucketLayout:
    """Leaf-aligned layout over an explicit ordered leaf-size list (the
    overlapped step orders the leaves by backward completion, which is not
    the parameter order, so it builds its layout from sizes)."""
    bucket_elems = _bucket_elems(dtype, bucket_mb)
    sizes, leaf_bucket = leaf_aligned_sizes(leaf_sizes, bucket_elems)
    return BucketLayout(int(sum(leaf_sizes)), bucket_elems, len(sizes),
                        dtype, sizes,
                        leaf_sizes=tuple(int(s) for s in leaf_sizes),
                        leaf_bucket=leaf_bucket)


def layout_for(leaves: Sequence[torch.Tensor], bucket_mb: float,
               leaf_aligned: bool = False) -> BucketLayout:
    """Layout over ``leaves`` (any tensors with the gradients' shapes and
    dtypes, in leaf order): byte-based boundaries, or leaf-aligned ones
    with ``leaf_aligned=True``."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("empty gradient list")
    dtype = _majority_dtype(leaves)
    if leaf_aligned:
        return layout_from_leaf_sizes([t.numel() for t in leaves], dtype,
                                      bucket_mb)
    n = sum(t.numel() for t in leaves)
    bucket_elems = _bucket_elems(dtype, bucket_mb)
    n_buckets = -(-n // bucket_elems)
    sizes = [bucket_elems] * (n_buckets - 1)
    sizes.append(n - bucket_elems * (n_buckets - 1))
    return BucketLayout(n, bucket_elems, n_buckets, dtype, tuple(sizes))


def leaves_to_buckets(leaves: Sequence[torch.Tensor],
                      layout: BucketLayout) -> list[torch.Tensor]:
    """Leaf-aligned assembly: each bucket is the concatenation of its own
    leaves, cast to the bucket dtype; no whole-gradient flat vector."""
    if layout.leaf_sizes is None or len(leaves) != len(layout.leaf_sizes):
        raise ValueError(f"{len(leaves)} leaves for a layout of "
                         f"{layout.leaf_sizes and len(layout.leaf_sizes)}")
    per_bucket: list[list[torch.Tensor]] = [[] for _ in
                                            range(layout.n_buckets)]
    for t, b in zip(leaves, layout.leaf_bucket):
        per_bucket[b].append(t.reshape(-1).to(layout.dtype))
    return [parts[0] if len(parts) == 1 else torch.cat(parts)
            for parts in per_bucket]


def buckets_to_leaves(buckets: Sequence[torch.Tensor],
                      leaves_like: Sequence[torch.Tensor],
                      layout: BucketLayout) -> list[torch.Tensor]:
    """Inverse of :func:`leaves_to_buckets`: split each bucket back into
    its leaves (shapes and dtypes from ``leaves_like``, same order)."""
    if layout.leaf_bucket is None:
        raise ValueError("buckets_to_leaves needs a leaf-aligned layout")
    out, off, cur = [], 0, 0
    for like, b in zip(leaves_like, layout.leaf_bucket):
        if b != cur:
            cur, off = b, 0
        n = like.numel()
        out.append(buckets[b][off:off + n].reshape(like.shape)
                   .to(like.dtype))
        off += n
    return out


def to_buckets(leaves: Sequence[torch.Tensor],
               layout: BucketLayout) -> list[torch.Tensor]:
    """Ravel the leaves into their list of 1-D buckets, cast to the bucket
    dtype: per-leaf assembly for a leaf-aligned layout, views of one flat
    concatenation for a byte-based one."""
    if layout.leaf_aligned:
        return leaves_to_buckets(leaves, layout)
    flat = torch.cat([t.reshape(-1).to(layout.dtype) for t in leaves])
    if flat.shape[0] != layout.n_elements:
        raise ValueError(f"{flat.shape[0]} elements for a layout of "
                         f"{layout.n_elements}")
    return list(flat.split(list(layout.sizes)))


def read_flat(leaves: Sequence[torch.Tensor], start: int, out: torch.Tensor,
              dtype: Any, scale: "torch.Tensor | None" = None
              ) -> torch.Tensor:
    """Fill ``out`` with the flat range ``[start, start + len(out))`` of the
    leaves raveled in order and cast to ``dtype`` (then to ``out``'s
    dtype); zeros past the last element.  Copies leaf by leaf: the flat
    vector itself is never built.  With ``scale`` each leaf's piece is
    first multiplied by it in the leaf's dtype (the bits of scaling the
    whole leaf, as ``clip_by_global_norm`` does, without its copy)."""
    end = start + out.shape[0]
    lo = 0
    for t in leaves:
        hi = lo + t.numel()
        a, b = max(lo, start), min(hi, end)
        if a < b:
            piece = t.reshape(-1)[a - lo:b - lo]
            if scale is not None:
                piece = piece * scale.to(t.dtype)
            out[a - start:b - start].copy_(piece.to(dtype))
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
    if layout.leaf_aligned:
        return buckets_to_leaves(buckets, leaves_like, layout)
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
