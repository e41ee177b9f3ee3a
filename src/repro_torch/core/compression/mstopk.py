"""MSTop-K (Shi et al., 2021): magnitude top-k sparsification.
Counterpart of ``repro.core.compression.mstopk``.

Not associative: the ranks' index sets differ, so the payload ((values,
indices) pairs) all-gathers and every rank scatter-adds them locally; the
buffer grows linearly in p, the paper's out-of-memory failure at 32/16
GPUs.  Selection is the exact ``ops.topk_select`` on every device, as in
the JAX package; the threshold-and-mask kernel (``ops.topk_threshold_mask``)
is a separate op that no compressor calls.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.compression.base import (Compressor, Payload,
                                               register_compressor)
from repro_torch.kernels import ops as kops


class TopKState(NamedTuple):
    err: torch.Tensor    # (n,) error-feedback memory, or (1,) unused


@register_compressor("mstopk", frac="topk_frac",
                     error_feedback="error_feedback")
class MSTopK(Compressor):
    associative = False

    def __init__(self, frac: float = 0.01, error_feedback: bool = True):
        if not 0 < frac <= 1:
            raise ValueError(f"mstopk frac must be in (0, 1], got {frac}")
        self.frac = frac
        self.error_feedback = error_feedback
        self.name = f"mstopk-{frac:g}"

    def k_for(self, n: int) -> int:
        return max(1, int(n * self.frac))

    def init_state(self, n: int, generator: Optional[torch.Generator] = None,
                   device: "str | torch.device" = "cpu") -> TopKState:
        return TopKState(err=torch.zeros(
            (n,) if self.error_feedback else (1,), dtype=torch.float32,
            device=device))

    def encode(self, bucket: torch.Tensor, state: TopKState,
               rank: Optional[int] = None) -> Payload:
        g = self._compensated(bucket, state)
        vals, idx = kops.topk_select(g, self.k_for(bucket.shape[0]))
        return Payload({"vals": vals, "idx": idx}, associative=False)

    def decode(self, payload: Payload, bucket: torch.Tensor,
               state: TopKState):
        n = bucket.shape[0]
        gv = payload.tensors["vals"]                   # (p, k)
        gi = payload.tensors["idx"]
        dense = torch.zeros((n,), dtype=torch.float32, device=gv.device)
        dense.index_add_(0, gi.reshape(-1).long(), gv.reshape(-1))
        out = dense / gv.shape[0]
        if self.error_feedback:
            g = self._compensated(bucket, state)
            own = torch.zeros_like(g)
            own[payload.local["idx"].long()] = payload.local["vals"]
            new_err = g - own
        else:
            new_err = state.err
        return out.to(bucket.dtype), TopKState(err=new_err)

    def encode_decode_flops(self, n):
        k = self.k_for(n)
        return n * max(1.0, math.log2(max(k, 2)))  # selection ~ n log k
