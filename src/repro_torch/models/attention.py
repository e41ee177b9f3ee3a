"""Grouped-query attention in plain PyTorch, causal or not.

Counterpart of ``repro.models.attention.chunked_attention``, which is plain
JAX, not a Pallas kernel.  Scores, softmax and the weighted sum run in fp32
and the result is cast back to the input dtype.  Query head h reads key /
value head ``h // (H / KVh)``, the JAX package's grouping.  The JAX function
walks the keys in chunks of 1024 with an online softmax; this one takes
the softmax in one pass, which is the same arithmetic for up to 1024 keys
and equal up to rounding beyond.

``decode_attention`` is serving's one-token step against a KV cache
(JAX ``decode_attention``): a cache slot is valid when its position is
below the row's ``cur_len``; under context parallelism (the cache's
sequence dim sharded over ``seq_shard_axes``) the partial softmax of each
rank is merged by log-sum-exp: the ``pmax`` of the row maxima, then the
``psum`` of the denominators and of P·V over those axes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel import collectives as coll

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_positions: Optional[torch.Tensor] = None,
              k_positions: Optional[torch.Tensor] = None, *,
              causal: bool) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KVh, hd) with KVh | H.  With
    ``causal`` key j is visible to query i when its position (``k_positions``
    (B, Sk)) is <= i's (``q_positions`` (B, Sq)); without, every key is and
    the positions are not read (the JAX package's mask for unpadded keys:
    the encoder's self-attention and the decoder's cross-attention)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, hd) * hd ** -0.5
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, k.float())
    if causal:
        mask = k_positions[:, None, None, None, :] \
            <= q_positions[:, :, None, None, None]
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    out = out / den.clamp(min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Self-attention of a decoder: q, k, v over the same (B, S)
    ``positions``, each key visible to the queries at or after it."""
    return attention(q, k, v, positions, positions, causal=True)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor,
                     cache_positions: Optional[torch.Tensor] = None,
                     seq_shard_axes: tuple[str, ...] = ()) -> torch.Tensor:
    """One query token against a cache.  q: (B, 1, H, hd); caches (B, Sc,
    KVh, hd); ``cur_len`` (B,) the number of valid positions (global);
    ``cache_positions`` (B, Sc) the absolute position of each local slot
    (``arange(Sc)`` when None).  Scores in fp32; the result in q's
    dtype."""
    b, _, h, hd = q.shape
    sc, kvh = k_cache.shape[1], k_cache.shape[2]
    if cache_positions is None:
        cache_positions = torch.arange(sc, device=q.device).expand(b, sc)
    qg = q.float().reshape(b, kvh, h // kvh, hd) * hd ** -0.5
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float())
    valid = cache_positions[:, None, None, :] < cur_len[:, None, None, None]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1)
    if seq_shard_axes:
        m = coll.pmax(m, seq_shard_axes)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1)
    pv = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    if seq_shard_axes:
        den = coll.psum(den, seq_shard_axes)
        pv = coll.psum(pv, seq_shard_axes)
    out = pv / den.clamp(min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)
