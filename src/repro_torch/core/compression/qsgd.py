"""QSGD (Alistarh et al., 2017): stochastic uniform quantization.
Counterpart of ``repro.core.compression.qsgd``.

Not associative: re-quantizing after a sum is lossy, so the payload (int8
levels plus the bucket's fp32 norm) all-gathers and every rank
dequantizes locally; the wire cost grows linearly in p.  Levels ride the
wire as int8 whatever ``bits`` is (no sub-byte packing).  Unbiased:
E[decode(encode(g))] = g.

The norm is computed on the bucket's device and reaches the quantize
kernel (``repro_torch.kernels.ops``) as a 0-dim tensor.  The stochastic
rounding draws one uniform per element in ``uniform``, the one place this
scheme draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.compression.base import (Compressor, Payload,
                                               new_key, rank_uniform,
                                               register_compressor, split_key)
from repro_torch.kernels import ops as kops


class QSGDState(NamedTuple):
    key: torch.Tensor    # (2,) int64 on the host
    err: torch.Tensor    # (n,) error-feedback memory, or (1,) unused


def uniform(key: torch.Tensor, rank: Optional[int], n: int,
            device: "str | torch.device") -> torch.Tensor:
    """The (n,) uniform draw of one encode, different on each rank: the one
    place this scheme draws."""
    return rank_uniform(key, rank, n, device)


@register_compressor("qsgd", bits="qsgd_bits",
                     error_feedback="error_feedback")
class QSGD(Compressor):
    associative = False

    def __init__(self, bits: int = 8, error_feedback: bool = False):
        if not 2 <= bits <= 8:
            raise ValueError(f"qsgd bits must be in [2, 8], got {bits}")
        self.bits = bits
        self.levels = 2 ** (bits - 1) - 1      # signed levels
        self.error_feedback = error_feedback
        self.name = f"qsgd-{bits}b"

    def init_state(self, n: int, generator: Optional[torch.Generator] = None,
                   device: "str | torch.device" = "cpu") -> QSGDState:
        return QSGDState(key=new_key(generator), err=torch.zeros(
            (n,) if self.error_feedback else (1,), dtype=torch.float32,
            device=device))

    def encode(self, bucket: torch.Tensor, state: QSGDState,
               rank: Optional[int] = None) -> Payload:
        g = self._compensated(bucket, state)
        norm = torch.linalg.vector_norm(g) + 1e-12
        u = uniform(state.key, rank, g.shape[0], g.device)
        return Payload({"q": kops.qsgd_quantize(g, norm, self.levels, u),
                        "norm": norm}, associative=False)

    def _dequantize(self, q: torch.Tensor, norm: torch.Tensor):
        return q.float() * (norm / self.levels)

    def decode(self, payload: Payload, bucket: torch.Tensor,
               state: QSGDState):
        gq = payload.tensors["q"]                      # (p, n) int8
        gn = payload.tensors["norm"]                   # (p,)
        out = torch.einsum("pn,p->n", gq.float(), gn / self.levels) \
            / gq.shape[0]
        key, _ = split_key(state.key)
        if self.error_feedback:
            new_err = self._compensated(bucket, state) - self._dequantize(
                payload.local["q"], payload.local["norm"])
        else:
            new_err = state.err
        return out.to(bucket.dtype), QSGDState(key=key, err=new_err)

    def encode_decode_flops(self, n):
        return 6.0 * n
