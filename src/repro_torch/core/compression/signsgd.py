"""SignSGD with majority vote (Bernstein et al., 2018), the scaled variant.
Counterpart of ``repro.core.compression.signsgd``.

Not associative: the majority vote needs every rank's sign bitmap, so the
payload (packed bits plus the local mean |g|) all-gathers, and the wire
cost grows linearly in p.  Decode counts the positive votes per element,
takes ``+1`` where ``2 * votes >= p`` and ``-1`` elsewhere, and scales by
the mean of the gathered scales.  Packing and counting go through
``repro_torch.kernels.ops``: the CUDA kernels on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.compression.base import (Compressor, Payload,
                                               register_compressor)
from repro_torch.kernels import ops as kops


class SignSGDState(NamedTuple):
    err: torch.Tensor


@register_compressor("signsgd", error_feedback="error_feedback")
class SignSGDMajorityVote(Compressor):
    name = "signsgd"
    associative = False

    def __init__(self, error_feedback: bool = True):
        self.error_feedback = error_feedback

    def init_state(self, n: int, generator: Optional[torch.Generator] = None,
                   device: "str | torch.device" = "cpu") -> SignSGDState:
        return SignSGDState(err=torch.zeros(
            (n,) if self.error_feedback else (1,), dtype=torch.float32,
            device=device))

    def encode(self, bucket: torch.Tensor, state: SignSGDState,
               rank: Optional[int] = None) -> Payload:
        g = self._compensated(bucket, state)
        return Payload({"bits": kops.pack_signs(g),
                        "scale": g.abs().mean()},
                       associative=False)

    def decode(self, payload: Payload, bucket: torch.Tensor,
               state: SignSGDState):
        n = bucket.shape[0]
        gathered = payload.tensors["bits"]                # (p, words)
        votes = kops.popcount_votes(gathered, n)          # (n,) #positive
        p = gathered.shape[0]
        majority = torch.where(2 * votes >= p, 1.0, -1.0).float()
        out = majority * payload.tensors["scale"].mean()
        if self.error_feedback:
            new_err = self._compensated(bucket, state) - out
        else:
            new_err = state.err
        return out.to(bucket.dtype), SignSGDState(err=new_err)

    def encode_decode_flops(self, n):
        # pack, then unpack and count: about 8 operations per element
        return 8.0 * n
