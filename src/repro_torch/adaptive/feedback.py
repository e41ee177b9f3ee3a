"""Error feedback as a wrapper on the Payload contract.  Counterpart of
``repro.adaptive.feedback``.

``ef:<name>`` wraps a registered compressor in a per-bucket fp32 residual
(Seide et al., 2014; Karimireddy et al., 2019):

    encode     runs on  g + residual
    decode     returns  the mean as usual, and keeps
    residual' = (g + residual) - own_decoded   (what this rank failed to
                                                put on the wire)

``own_decoded`` is reconstructed from ``payload.local``, this rank's
pre-reduce tensors, by decoding them again as a payload with a peer axis
of size 1: no second encode, and no knowledge of the inner scheme's math.

An inner scheme's own ``error_feedback`` switch is forced off (the wrapper
owns the one residual).  PowerSGD's error feedback is structural
(``builtin_error_feedback``), so ``ef:powersgd`` raises ``ValueError``
instead of compensating twice.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.compression.base import EF_PREFIX  # noqa: F401
from repro_torch.core.compression.base import Compressor, Payload


class EFState(NamedTuple):
    """Inner compressor state and the wrapper's fp32 residual."""
    inner: Any
    residual: torch.Tensor     # (n,) fp32


class ErrorFeedback(Compressor):
    """Wrap ``inner`` with a residual added before encode and updated after
    decode.  Associativity, wire accounting and the round structure are
    the inner compressor's."""

    def __init__(self, inner: Compressor):
        if getattr(inner, "builtin_error_feedback", False):
            raise ValueError(
                f"{inner.name!r} has structural (always-on) error feedback;"
                " wrapping it in ef: would compensate twice - use the plain"
                " compressor")
        if getattr(inner, "error_feedback", False):
            inner.error_feedback = False
        self.inner = inner
        self.associative = inner.associative
        self.name = f"ef:{inner.name}"
        self.registry_name = f"ef:{inner.registry_name}"

    def init_state(self, n: int, generator: Optional[torch.Generator] = None,
                   device: "str | torch.device" = "cpu") -> EFState:
        return EFState(inner=self.inner.init_state(n, generator, device),
                       residual=torch.zeros((n,), dtype=torch.float32,
                                            device=device))

    def _carry(self, bucket: torch.Tensor, state: EFState) -> torch.Tensor:
        """The error-compensated fp32 gradient the inner scheme encodes."""
        return bucket.float() + state.residual

    def encode(self, bucket: torch.Tensor, state: EFState,
               rank: Optional[int] = None) -> Payload:
        return self.inner.encode(self._carry(bucket, state), state.inner,
                                 rank=rank)

    # the base ``encode_and_reduce`` calls ``self.encode`` and the shared
    # ``reduce_payload``; PowerSGD, the one scheme with its own rounds, is
    # rejected in __init__.

    def decode(self, payload: Payload, bucket: torch.Tensor, state: EFState):
        g = self._carry(bucket, state)
        mean, new_inner = self.inner.decode(payload, g, state.inner)
        own = self._own_decoded(payload, g, state)
        return mean.to(bucket.dtype), \
            EFState(inner=new_inner, residual=g - own.float())

    def _own_decoded(self, payload: Payload, g: torch.Tensor,
                     state: EFState) -> torch.Tensor:
        """What this rank put on the wire, decoded from ``payload.local``
        as a payload of one peer."""
        local = payload.tensors if payload.local is None else payload.local
        tensors = local if payload.associative else \
            {k: t[None] for k, t in local.items()}     # peer axis of size 1
        own, _ = self.inner.decode(
            Payload(tensors, associative=payload.associative, local=local),
            g, state.inner)
        return own

    def wire_rounds(self, bucket: torch.Tensor,
                    state: EFState) -> list[Payload]:
        return self.inner.wire_rounds(self._carry(bucket, state), state.inner)

    def encode_decode_flops(self, n: int) -> float:
        # + the residual's add and subtract
        return self.inner.encode_decode_flops(n) + 2.0 * n


def wrap_error_feedback(inner: Compressor) -> ErrorFeedback:
    """The ``ef:`` factory body (``base.make`` calls it on the prefix)."""
    return ErrorFeedback(inner)
