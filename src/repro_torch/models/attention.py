"""Causal grouped-query attention in plain PyTorch.

Counterpart of ``repro.models.attention.chunked_attention``, which is plain
JAX, not a Pallas kernel.  Scores, softmax and the weighted sum run in fp32
and the result is cast back to the input dtype.  Query head h reads key /
value head ``h // (H / KVh)``, the JAX package's grouping.  The JAX function
walks the keys in chunks of 1024 with an online softmax; this one takes
the softmax in one pass, which is the same arithmetic for up to 1024 keys
and equal up to rounding beyond.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KVh, hd) with KVh | H; positions:
    (B, S).  Key j is visible to query i when its position is <= i's."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, hd) * hd ** -0.5
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, k.float())
    mask = positions[:, None, None, None, :] \
        <= positions[:, :, None, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    out = out / den.clamp(min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)
