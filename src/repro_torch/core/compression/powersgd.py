"""PowerSGD (Vogels et al., 2019) — rank-r gradient compression.
Counterpart of ``repro.core.compression.powersgd``.

Per bucket of n elements, reshaped to an (rows x cols) matrix M:

    M   = grad + error                      (error feedback, built in)
    P   = mean_p(M_i @ Q)                   <- reduce round 1, rows x r
    P^  = orthonormalize(P)                 (modified Gram-Schmidt)
    Q'  = mean_p(M_i^T @ P^)                <- reduce round 2, cols x r
    M^  = P^ @ Q'^T                         (identical on every rank)
    err = M - M^                            (persisted; Q' warm-starts)

``matrix_shape`` and ``orthonormalize`` are the JAX package's, so the wire
shapes and the Gram-Schmidt order match.  The two products and the decode
go through ``repro_torch.kernels.ops``: the CUDA kernels on the card, the
plain versions elsewhere.  Round 2 hands the encode kernel the transposed
*view* ``M^T``; it reads it by strides, so M is never copied.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.compression.base import (AxisNames, Compressor, Payload,
                                               reduce_payload,
                                               register_compressor)
from repro_torch.kernels import ops as kops


def matrix_shape(n: int, min_cols: int = 128) -> tuple[int, int]:
    """Near-square (rows, cols) with cols a multiple of ``min_cols``; tiny
    buckets (n < min_cols) collapse to a single row of n columns."""
    cols = int(n ** 0.5)
    cols = max(min_cols, -(-cols // min_cols) * min_cols)
    cols = min(cols, n)
    rows = -(-n // cols)
    return rows, cols


def orthonormalize(P: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Modified Gram-Schmidt over the (small) rank dimension."""
    cols = []
    for i in range(P.shape[1]):
        v = P[:, i]
        for u in cols:
            v = v - torch.dot(u, v) * u
        cols.append(v / (torch.linalg.vector_norm(v) + eps))
    return torch.stack(cols, dim=1)


class PowerSGDState(NamedTuple):
    q: torch.Tensor      # (cols, rank) warm-start factor
    err: torch.Tensor    # (n,) error-feedback memory


@register_compressor("powersgd", rank="powersgd_rank")
class PowerSGD(Compressor):
    associative = True
    builtin_error_feedback = True      # err and the warm start are its state

    def __init__(self, rank: int = 4, min_cols: int = 128):
        self.rank = rank
        self.min_cols = min_cols
        self.name = f"powersgd-r{rank}"

    def init_state(self, n: int, generator: Optional[torch.Generator] = None,
                   device: "str | torch.device" = "cpu") -> PowerSGDState:
        rows, cols = matrix_shape(n, self.min_cols)
        # warm start from a shared seed: identical on every rank
        q = torch.randn((cols, self.rank), generator=generator,
                        dtype=torch.float32, device=device)
        return PowerSGDState(q=q, err=torch.zeros((n,), dtype=torch.float32,
                                                  device=device))

    def _matrix(self, bucket: torch.Tensor, state: PowerSGDState):
        """(M, M_flat): the error-compensated bucket as a matrix, zero-padded
        to rows x cols (a view of M_flat when no padding is needed)."""
        n = bucket.shape[0]
        rows, cols = matrix_shape(n, self.min_cols)
        m_flat = bucket.float() + state.err
        m = m_flat
        if rows * cols != n:
            m = torch.nn.functional.pad(m_flat, (0, rows * cols - n))
        return m.reshape(rows, cols), m_flat

    # ---- phase 1: round-1 payload P = M @ Q -----------------------------
    def encode(self, bucket: torch.Tensor, state: PowerSGDState,
               rank: Optional[int] = None) -> Payload:
        m, _ = self._matrix(bucket, state)
        return Payload({"p": kops.powersgd_encode(m, state.q)},
                       associative=True)

    # ---- phase 2: two reduce rounds with Gram-Schmidt in between --------
    def encode_and_reduce(self, bucket: torch.Tensor, state: PowerSGDState,
                          axes: AxisNames, plan=None) -> Payload:
        m, _ = self._matrix(bucket, state)
        red1 = reduce_payload(
            Payload({"p": kops.powersgd_encode(m, state.q)},
                    associative=True), axes, plan)
        p_hat = orthonormalize(red1.tensors["p"])
        red2 = reduce_payload(
            Payload({"q": kops.powersgd_encode(m.T, p_hat)},
                    associative=True), axes, plan)
        return dataclasses.replace(
            red2, tensors={"p": p_hat, "q": red2.tensors["q"]})

    # ---- phase 3: M^ = P^ @ Q'^T + error update -------------------------
    def decode(self, payload: Payload, bucket: torch.Tensor,
               state: PowerSGDState):
        n = bucket.shape[0]
        p_hat, q_new = payload.tensors["p"], payload.tensors["q"]
        _, m_flat = self._matrix(bucket, state)
        m_hat_flat = kops.powersgd_decode(p_hat, q_new).reshape(-1)[:n]
        err = m_flat - m_hat_flat
        return m_hat_flat.to(bucket.dtype), PowerSGDState(q=q_new, err=err)

    # ---- wire accounting: one payload per reduce round ------------------
    def wire_rounds(self, bucket: torch.Tensor,
                    state: PowerSGDState) -> list[Payload]:
        round1 = self.encode(bucket, state)
        m, _ = self._matrix(bucket, state)
        # orthonormalize preserves shape, so P stands in for P^ here
        round2 = Payload(
            {"q": kops.powersgd_encode(m.T, round1.tensors["p"])},
            associative=True)
        return [round1, round2]

    def encode_decode_flops(self, n):
        rows, cols = matrix_shape(n, self.min_cols)
        matmuls = 3 * 2 * rows * cols * self.rank      # encode x2 + decode
        gs = 2 * rows * self.rank * self.rank          # Gram-Schmidt
        return matmuls + gs
