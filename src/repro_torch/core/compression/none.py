"""syncSGD baseline: raw (uncompressed) all-reduce mean.  encode is the
identity; the payload IS the bucket, so the derived wire bytes are exactly
``n * itemsize``.  Counterpart of ``repro.core.compression.none``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.compression.base import (Compressor, Payload,
                                               register_compressor)


@register_compressor("none")
class NoCompression(Compressor):
    name = "none"
    associative = True

    def encode(self, bucket: torch.Tensor, state,
               rank: Optional[int] = None) -> Payload:
        return Payload({"bucket": bucket}, associative=True)

    def decode(self, payload: Payload, bucket: torch.Tensor, state):
        return payload.tensors["bucket"].to(bucket.dtype), state
