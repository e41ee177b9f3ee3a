"""Primitive layers of the dense decoder (the tensor-parallel degree 1
subset of ``repro.models.layers``).

Weights are laid out ``(d_in, d_out)`` and applied as ``x @ w``, as in the
JAX package.  Parameters are stored in ``ShardCtx.param_dtype`` (fp32,
or bf16 working copies under ZeRO-1 and ``param_dtype="bfloat16"``) and
cast to ``ShardCtx.compute_dtype`` at use; norms, rotary angles, softmax
and the loss run in fp32.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    """In place: ``std`` times a standard normal truncated to [-3, 3],
    drawn in fp32 and cast to ``t``'s dtype before the scaling, as the
    JAX package's ``_trunc_normal`` does."""
    with torch.no_grad():
        draw = t if t.dtype == torch.float32 else torch.empty(
            t.shape, dtype=torch.float32, device=t.device)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        if draw is not t:
            t.copy_(draw)
        return t.mul_(std)


def linear(w: torch.Tensor, x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) in the compute dtype."""
    return x @ w.to(ctx.compute_dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs               # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute positions (...) -> (..., d) fp32 ``[sin | cos]`` over
    ``d // 2`` frequencies ``1 / 10000^(i / (d // 2))``: the enc-dec
    family's positional input under ``rope="none"``."""
    half = d // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=positions.device) / half))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, ctx: ShardCtx,
                     vocab: int) -> torch.Tensor:
    """ids: (B, S) -> (B, S, d) in the compute dtype."""
    return torch.nn.functional.embedding(ids.clamp(max=vocab - 1),
                                         table.to(ctx.compute_dtype))


def unembed_logits(table: torch.Tensor, x: torch.Tensor,
                   ctx: ShardCtx) -> torch.Tensor:
    """x: (B, S, d) -> logits (B, S, V)."""
    return x @ table.to(ctx.compute_dtype).T


def vocab_parallel_xent(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy in fp32: logsumexp - gold logit."""
    ll = logits.float()
    lse = torch.logsumexp(ll, dim=-1)
    gold = torch.gather(ll, -1, labels[..., None])[..., 0]
    return lse - gold
