"""Random-k sparsification (Wangni et al., 2018).  Counterpart of
``repro.core.compression.randomk``.

Associative: every rank selects the same k random coordinates (the state's
key is the same on every rank), so the payload is a dense length-k value
vector that reduces with a plain mean, at a cost constant in p.  The
indices never cross the wire: ``decode`` draws them again from the same
key, so the wire bytes are exactly 4 k.  ``indices`` is the one place this
scheme draws.

``rescale=True`` gives the unbiased estimator (x n/k); with error feedback
the usual practice is no rescale (the residual re-injects the mass).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.compression.base import (Compressor, Payload,
                                               key_generator, new_key,
                                               register_compressor, split_key)


class RandomKState(NamedTuple):
    key: torch.Tensor    # (2,) int64 on the host
    err: torch.Tensor    # (n,) error-feedback memory, or (1,) unused


def indices(key: torch.Tensor, n: int, k: int,
            device: "str | torch.device") -> torch.Tensor:
    """The k shared coordinates of one step: the first k of a permutation
    of range(n) drawn from the key's ``sub`` half, the same on every rank
    and in ``encode`` and ``decode`` of one step."""
    _, sub = split_key(key)
    return torch.randperm(n, generator=key_generator(sub, device),
                          device=device)[:k]


@register_compressor("randomk", error_feedback="error_feedback")
class RandomK(Compressor):
    associative = True

    def __init__(self, frac: float = 0.01, rescale: bool = False,
                 error_feedback: bool = True):
        self.frac = frac
        self.rescale = rescale
        self.error_feedback = error_feedback
        self.name = f"randomk-{frac:g}"

    def k_for(self, n: int) -> int:
        return max(1, int(n * self.frac))

    def init_state(self, n: int, generator: Optional[torch.Generator] = None,
                   device: "str | torch.device" = "cpu") -> RandomKState:
        return RandomKState(key=new_key(generator), err=torch.zeros(
            (n,) if self.error_feedback else (1,), dtype=torch.float32,
            device=device))

    def encode(self, bucket: torch.Tensor, state: RandomKState,
               rank: Optional[int] = None) -> Payload:
        n = bucket.shape[0]
        idx = indices(state.key, n, self.k_for(n), bucket.device)
        return Payload({"vals": self._compensated(bucket, state)[idx]},
                       associative=True)

    def _scatter(self, n: int, idx: torch.Tensor, vals: torch.Tensor,
                 scale: float) -> torch.Tensor:
        out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
        out[idx] = vals * scale
        return out

    def decode(self, payload: Payload, bucket: torch.Tensor,
               state: RandomKState):
        n = bucket.shape[0]
        k = self.k_for(n)
        idx = indices(state.key, n, k, bucket.device)
        scale = (n / k) if self.rescale else 1.0
        out = self._scatter(n, idx, payload.tensors["vals"], scale)
        key, _ = split_key(state.key)
        if self.error_feedback:
            g = self._compensated(bucket, state)
            own_vals = payload.local["vals"] if payload.local is not None \
                else g[idx]
            new_err = g - self._scatter(n, idx, own_vals, scale)
        else:
            new_err = state.err
        return out.to(bucket.dtype), RandomKState(key=key, err=new_err)

    def encode_decode_flops(self, n):
        return 4.0 * n  # permutation + gather/scatter ~ O(n)
