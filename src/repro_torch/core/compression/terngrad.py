"""TernGrad (Wen et al., 2017): stochastic ternarization to {-1, 0, +1}
times a per-rank scale.  Counterpart of ``repro.core.compression.terngrad``.

Not associative: the ranks' scales differ, so the payload (int8 ternaries
plus the fp32 scale) all-gathers.  Unbiased by construction: an element
keeps its sign with probability |g| / max|g|.  The draw is ``u < |g| /
scale`` with no kernel, as in the JAX package; ``uniform`` is the one
place this scheme draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.compression.base import (Compressor, Payload,
                                               new_key, rank_uniform,
                                               register_compressor, split_key)


class TernGradState(NamedTuple):
    key: torch.Tensor    # (2,) int64 on the host
    err: torch.Tensor    # (n,) error-feedback memory, or (1,) unused


def uniform(key: torch.Tensor, rank: Optional[int], n: int,
            device: "str | torch.device") -> torch.Tensor:
    """The (n,) uniform draw of one encode, different on each rank: the one
    place this scheme draws."""
    return rank_uniform(key, rank, n, device)


@register_compressor("terngrad", error_feedback="error_feedback")
class TernGrad(Compressor):
    name = "terngrad"
    associative = False

    def __init__(self, error_feedback: bool = False):
        self.error_feedback = error_feedback

    def init_state(self, n: int, generator: Optional[torch.Generator] = None,
                   device: "str | torch.device" = "cpu") -> TernGradState:
        return TernGradState(key=new_key(generator), err=torch.zeros(
            (n,) if self.error_feedback else (1,), dtype=torch.float32,
            device=device))

    def encode(self, bucket: torch.Tensor, state: TernGradState,
               rank: Optional[int] = None) -> Payload:
        g = self._compensated(bucket, state)
        scale = g.abs().max() + 1e-12
        u = uniform(state.key, rank, g.shape[0], g.device)
        bern = (u < g.abs() / scale).to(torch.int8)
        tern = torch.sign(g).to(torch.int8) * bern
        return Payload({"tern": tern, "scale": scale}, associative=False)

    def decode(self, payload: Payload, bucket: torch.Tensor,
               state: TernGradState):
        gt = payload.tensors["tern"]                   # (p, n) int8
        gs = payload.tensors["scale"]                  # (p,)
        out = torch.einsum("pn,p->n", gt.float(), gs) / gt.shape[0]
        key, _ = split_key(state.key)
        if self.error_feedback:
            new_err = self._compensated(bucket, state) \
                - payload.local["tern"].float() * payload.local["scale"]
        else:
            new_err = state.err
        return out.to(bucket.dtype), TernGradState(key=key, err=new_err)

    def encode_decode_flops(self, n):
        return 5.0 * n
