"""The enc-dec backbone of the audio family (``seamless-m4t-medium``):
counterpart of ``repro.models.encdec``, in train mode.

The speech frontend is a stub, as in the JAX package: the encoder reads
precomputed ``(B, S_enc, d_model)`` frame embeddings.  The encoder block
is pre-norm bidirectional self-attention and a pre-norm GELU MLP; the
decoder block adds cross-attention over the encoder's output (the
``memory``) between its causal self-attention and its MLP.  Neither
rotates q and k (``rope="none"``): the model adds sinusoidal positions
to both stacks' inputs.

A block's parameters arrive as a dict keyed by their names under
``enc_blocks.`` or ``dec_blocks.``, one layer's slice of the stacked
leaves (``enc_layout``, ``dec_layout``).  The JAX package's cross-
attention also projects the memory through ``wq`` and drops the result
(``cross_kv`` via ``_project_qkv``); its gradient is zero, and the port
skips that product.  The decode path (``dec_cache_shape``, the cross K/V
computed once at prefill and carried in the cache) belongs to serving and
is not ported.  The cross-attention runs inside the profiler range
``CROSS``.

Tensor parallelism (``ctx.tp > 1``): every attention holds the
``head_layout``'s heads (the q heads padded to ``n_h_pad``, as the JAX
package's ``attn_init`` pads them) and the GELU MLP is column- then
row-parallel, as in the dense block.  The cross-attention takes q from
``tp_copy`` of the decoder states and k and v from the memory, which is
whole on every model rank (``Model.stage_memory`` enters it through
``tp_copy``, whose backward sums the memory's partial gradients over
``model``); its padded heads are masked before the row-parallel ``wo``
and ``tp_reduce``.  Under SP the block norms read their scales under
``sp_shared``.
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from repro_torch.models import transformer as tf
from repro_torch.models.attention import attention
from repro_torch.models.layers import (ShardCtx, head_layout, linear,
                                       local_head_mask, rmsnorm, sp_shared,
                                       tp_copy, tp_reduce)
from repro_torch.parallel.collectives import tp_index

#: the profiler range around the cross-attention
CROSS = "encdec.cross"


def _attn_layout(cfg, prefix: str, lead: tuple, tp: int) -> list:
    """``wk``, ``wo``, ``wq``, ``wv`` of one attention, in leaf order, the
    q heads padded as ``head_layout`` pads them at ``tp``."""
    d, hd = cfg.d_model, cfg.head_dim
    q_out = head_layout(cfg.n_heads, cfg.n_kv_heads, hd, tp).n_h_pad * hd
    kv_out = cfg.n_kv_heads * hd
    return [(prefix + "wk.w", (*lead, d, kv_out), 1 / math.sqrt(d)),
            (prefix + "wo.w", (*lead, q_out, d),
             1 / math.sqrt(cfg.n_heads * hd)),
            (prefix + "wq.w", (*lead, d, q_out), 1 / math.sqrt(d)),
            (prefix + "wv.w", (*lead, d, kv_out), 1 / math.sqrt(d))]


def _norms(prefix: str, lead: tuple, d: int, names) -> list:
    return [(f"{prefix}{n}.scale", (*lead, d), None) for n in names]


def _mlp_layout(cfg, prefix: str, lead: tuple) -> list:
    d, f = cfg.d_model, cfg.d_ff
    return [(prefix + "mlp.fc1.w", (*lead, d, f), 1 / math.sqrt(d)),
            (prefix + "mlp.fc2.w", (*lead, f, d), 1 / math.sqrt(f))]


def enc_layout(cfg, lead: tuple, prefix: str, tp: int = 1) -> list:
    """(name, shape, init) of the encoder block's leaves at ``tp``, in
    leaf order: ``attn.{wk,wo,wq,wv}.w``, ``ln1``, ``ln2``,
    ``mlp.{fc1,fc2}.w``."""
    return _attn_layout(cfg, prefix + "attn.", lead, tp) \
        + _norms(prefix, lead, cfg.d_model, ("ln1", "ln2")) \
        + _mlp_layout(cfg, prefix, lead)


def dec_layout(cfg, lead: tuple, prefix: str, tp: int = 1) -> list:
    """(name, shape, init) of the decoder block's leaves at ``tp``, in
    leaf order: ``cross.*``, ``ln1``, ``ln2``, ``ln3``, ``mlp.*``,
    ``self.*``."""
    return _attn_layout(cfg, prefix + "cross.", lead, tp) \
        + _norms(prefix, lead, cfg.d_model, ("ln1", "ln2", "ln3")) \
        + _mlp_layout(cfg, prefix, lead) \
        + _attn_layout(cfg, prefix + "self.", lead, tp)


def cross_attn_apply(p: dict, x: torch.Tensor, memory: torch.Tensor, cfg,
                     ctx: ShardCtx) -> torch.Tensor:
    """x: the pre-normed (B, Sq, d) decoder states (this rank's slice of
    the sequence under SP); memory: (B, S_enc, d), whole.  q from ``x``,
    k and v from ``memory`` (``cross.{wq,wk,wv}.w``), every memory
    position visible; returns the output projection ``cross.wo.w`` (the
    caller adds the residual)."""
    lay = head_layout(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ctx.tp)
    m = tp_index() if ctx.tp > 1 else 0
    hd = cfg.head_dim
    with record_function(CROSS):
        h = tp_copy(x, ctx)
        b, sq, _ = h.shape
        q = linear(p["cross.wq.w"], h, ctx).reshape(b, sq, lay.L, hd)
        k, v = tf.kv_project(p, "cross.", memory, lay, m, ctx)
        out = attention(q, k, v, causal=False)
        if lay.padded:
            out = out * local_head_mask(lay, m, out.device)[:, None].to(
                out.dtype)
        out = linear(p["cross.wo.w"], out.reshape(b, sq, lay.L * hd), ctx)
        return tp_reduce(out, ctx)


def enc_block_apply(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg, ctx: ShardCtx) -> torch.Tensor:
    """Pre-norm bidirectional self-attention, then the pre-norm GELU MLP."""
    x = x + tf.attn_apply(p, rmsnorm(sp_shared(p["ln1.scale"], ctx), x,
                                     cfg.norm_eps),
                          positions, cfg, ctx, causal=False)
    return x + tf.gelu_mlp_apply(p, rmsnorm(sp_shared(p["ln2.scale"], ctx),
                                            x, cfg.norm_eps), ctx)


def dec_block_apply(p: dict, x: torch.Tensor, memory: torch.Tensor,
                    positions: torch.Tensor, cfg, ctx: ShardCtx
                    ) -> torch.Tensor:
    """Causal self-attention (``ln1``), cross-attention over ``memory``
    (``ln2``), then the GELU MLP (``ln3``), each pre-norm and residual."""
    def norm(name, x):
        return rmsnorm(sp_shared(p[name + ".scale"], ctx), x, cfg.norm_eps)
    x = x + tf.attn_apply(p, norm("ln1", x), positions, cfg, ctx,
                          prefix="self.")
    x = x + cross_attn_apply(p, norm("ln2", x), memory, cfg, ctx)
    return x + tf.gelu_mlp_apply(p, norm("ln3", x), ctx)
