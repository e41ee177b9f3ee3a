"""Dense transformer backbone: the pre-norm GQA attention + SwiGLU block
and the chunked LM loss.  Counterpart of the dense-family parts of
``repro.models.transformer``, qk-norm
included (``cfg.qk_norm``: an RMSNorm over ``head_dim`` of each q and k
head after the projection, before the rotation, as qwen3 has it).  The
enc-dec family (``repro_torch.models.encdec``) reads the attention
without the rotation (``rope="none"``) and, in its encoder, without the
causal mask, and the two-matrix GELU MLP.  The vlm family rotates q and k
by M-RoPE (``cfg.rope == "mrope"``): its ``(3, B, S)``
``mrope_positions`` choose the angles, the ``(B, S)`` positions the
causal mask.  The GELU MLP and each chunk of the loss run inside the
profiler ranges ``GELU_MLP`` and ``LM_LOSS``.

A block's parameters arrive as a dict keyed by their names under
``blocks.`` (``"attn.wq.w"``, ``"ln1.scale"``, ...), one layer's slice of
the stacked leaves.

Tensor parallelism (``ctx.tp > 1``): the MLPs (SwiGLU and the enc-dec
GELU MLP) and the attention run between ``tp_copy`` and ``tp_reduce``
(JAX ``mlp_apply``, ``attn_apply``) on this rank's columns and rows; the
attention holds the ``head_layout``'s ``L`` q heads and ``kv_local`` kv
heads (the kv weights replicated under ``tp_shared`` and sliced when
``kv_heads < tp``; padded q heads masked before ``wo``); the qk-norm
scales are read under ``tp_shared``.  Under SP the activations between
the regions hold this rank's slice of the sequence, the norms on them
read their scales under ``sp_shared``, and the rotary positions stay
those of the whole sequence, which the attention sees after the
gather.  The loss gathers
the sequence once (``tp_copy``) after the final norm and runs the
vocabulary-parallel cross-entropy on each chunk.

Serving (JAX ``StepState``, ``_cache_write``, ``attn_apply``'s prefill
and decode branches, ``attn_cache_shape``, ``lm_logits``): a
:class:`StepState` names the mode.  Prefill attends over the prompt as
training does and writes its k and v at positions ``0..S-1`` into the
layer's cache ``{"k", "v"}`` (B, Sc, kv_local, hd); decode rotates the
one new token at position ``cur_len``, writes it at slot ``cur_len``
and attends over the cache (``attention.decode_attention``).  The
writes are in place, into views of the preallocated cache.  Under
context parallelism (``ctx.cache_seq_axes``) each rank owns the span
``[off, off + Sc)``, ``off = rank(cache_seq_axes) * Sc``, and a write
outside it is dropped: prefill's through a slice of Python ints, decode's
through a clamped slot whose old value is written back (no host sync).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import (HeadLayout, ShardCtx, apply_mrope,
                                       apply_rope, head_layout, linear,
                                       local_head_mask, local_kv_slice,
                                       maybe_tp_shared, rmsnorm, sp_shared,
                                       tp_copy, tp_reduce, unembed_logits,
                                       vocab_parallel_xent)
from repro_torch.parallel.collectives import tp_index

#: the profiler ranges around the GELU MLP and one chunk of the loss head
GELU_MLP, LM_LOSS = "mlp.gelu", "lm_loss.chunk"


@dataclasses.dataclass(frozen=True)
class StepState:
    """The mode of a forward pass: ``"train"``, ``"prefill"`` or
    ``"decode"``; in decode, ``cur_len`` (B,) is the number of valid cache
    positions before the call (the new token's position)."""
    mode: str = "train"
    cur_len: Optional[torch.Tensor] = None


TRAIN = StepState()


def mlp_apply(p: dict, x: torch.Tensor, ctx: ShardCtx,
              prefix: str = "mlp.") -> torch.Tensor:
    """The SwiGLU MLP whose weights are ``p[prefix + "{gate,up,down}.w"]``
    (the MoE family's shared experts and dense residual use it too),
    column- then row-parallel between ``tp_copy`` and ``tp_reduce``."""
    h = tp_copy(x, ctx)
    g = linear(p[prefix + "gate.w"], h, ctx)
    u = linear(p[prefix + "up.w"], h, ctx)
    return tp_reduce(linear(p[prefix + "down.w"], F.silu(g) * u, ctx), ctx)


def gelu_mlp_apply(p: dict, x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The two-matrix MLP of the enc-dec blocks,
    ``mlp.fc2(gelu(mlp.fc1(x)))``, with the tanh form of the GELU:
    ``jax.nn.gelu``'s default; column- then row-parallel between
    ``tp_copy`` and ``tp_reduce``."""
    with record_function(GELU_MLP):
        h = F.gelu(linear(p["mlp.fc1.w"], tp_copy(x, ctx), ctx),
                   approximate="tanh")
        return tp_reduce(linear(p["mlp.fc2.w"], h, ctx), ctx)


def kv_project(p: dict, prefix: str, h: torch.Tensor, lay: HeadLayout,
               m: int, ctx: ShardCtx) -> tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, d), whole over ``model`` -> model rank ``m``'s k and v
    (B, S, kv_local, hd) from ``p[prefix + "{wk,wv}.w"]``: its columns of
    the kv weights, or where ``kv_heads < tp`` the replicated weights
    under ``tp_shared`` and its group's head sliced out."""
    b, s, _ = h.shape
    hd = lay.head_dim
    if lay.kv_replicated:
        cd = ctx.compute_dtype
        wk = maybe_tp_shared(p[prefix + "wk.w"].to(cd), ctx)
        wv = maybe_tp_shared(p[prefix + "wv.w"].to(cd), ctx)
        return (local_kv_slice((h @ wk).reshape(b, s, lay.kv_heads, hd),
                               lay, m),
                local_kv_slice((h @ wv).reshape(b, s, lay.kv_heads, hd),
                               lay, m))
    return (linear(p[prefix + "wk.w"], h, ctx).reshape(b, s, lay.kv_local,
                                                       hd),
            linear(p[prefix + "wv.w"], h, ctx).reshape(b, s, lay.kv_local,
                                                       hd))


def cache_offset(cache_len_local: int, ctx: ShardCtx) -> int:
    """The absolute position of this rank's first cache slot: its index
    along ``ctx.cache_seq_axes`` times the local capacity (0 without
    context parallelism)."""
    if not ctx.cache_seq_axes:
        return 0
    return mesh_mod.rank(ctx.cache_seq_axes) * cache_len_local


def cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                st: StepState, ctx: ShardCtx) -> None:
    """In place: prefill's k, v (B, S, kv_local, hd) at positions 0..S-1,
    or decode's one token (B, 1, kv_local, hd) at ``st.cur_len``, into
    the cache slots of this rank's span; writes outside it are
    dropped."""
    kc, vc = cache["k"], cache["v"]
    s_local = kc.shape[1]
    off = cache_offset(s_local, ctx)
    if st.mode == "prefill":
        hi = min(k.shape[1], off + s_local)
        if hi > off:
            kc[:, :hi - off] = k[:, off:hi]
            vc[:, :hi - off] = v[:, off:hi]
        return
    slot = st.cur_len.long() - off
    ok = ((slot >= 0) & (slot < s_local))[:, None, None]
    slot = slot.clamp(0, s_local - 1)
    rows = torch.arange(kc.shape[0], device=kc.device)
    for c, new in ((kc, k), (vc, v)):
        c[rows, slot] = torch.where(ok, new[:, 0].to(c.dtype), c[rows, slot])


def attn_cache_shape(cfg, ctx: ShardCtx, batch_local: int,
                     cache_len_local: int) -> tuple[int, ...]:
    """One layer's k (or v) cache on this rank: (B_local, Sc_local,
    kv_local, hd); the caller divides the capacity by the
    context-parallel degree."""
    lay = head_layout(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ctx.tp)
    return (batch_local, cache_len_local, lay.kv_local, lay.head_dim)


def attn_apply(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg,
               ctx: ShardCtx, causal: bool = True,
               prefix: str = "attn.",
               mrope_positions: "torch.Tensor | None" = None,
               step: StepState = TRAIN, cache: "dict | None" = None
               ) -> torch.Tensor:
    """x: the pre-normed (B, S, d) input; returns the attention output
    (the caller adds the residual) of the weights ``p[prefix + ...]``.
    q and k are rotated unless ``cfg.rope == "none"``, by M-RoPE over
    ``mrope_positions`` (3, B, S) under ``cfg.rope == "mrope"``;
    ``causal=False`` lets every query see every key.  In prefill and
    decode (``step``) the layer's ``cache`` is written in place; decode
    rotates at ``step.cur_len`` and attends over the cache."""
    lay = head_layout(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ctx.tp)
    m = tp_index() if ctx.tp > 1 else 0
    h = tp_copy(x, ctx)                     # the whole sequence under SP
    b, s, _ = h.shape
    hd = cfg.head_dim
    if step.mode == "decode":
        positions = step.cur_len[:, None]
    q = linear(p[prefix + "wq.w"], h, ctx).reshape(b, s, lay.L, hd)
    k, v = kv_project(p, prefix, h, lay, m, ctx)
    if cfg.qk_norm:
        q = rmsnorm(maybe_tp_shared(p[prefix + "q_norm.scale"], ctx), q,
                    cfg.norm_eps)
        k = rmsnorm(maybe_tp_shared(p[prefix + "k_norm.scale"], ctx), k,
                    cfg.norm_eps)
    if cfg.rope == "mrope":
        if mrope_positions is None:
            raise KeyError("mrope_positions")
        q = apply_mrope(q, mrope_positions, cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta)
    elif cfg.rope != "none":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if step.mode != "train":
        cache_write(cache, k, v, step, ctx)
    if step.mode == "decode":
        kc = cache["k"]
        pos = torch.arange(kc.shape[1], device=kc.device) \
            + cache_offset(kc.shape[1], ctx)
        out = decode_attention(q, kc, cache["v"], step.cur_len + 1,
                               pos.expand(b, -1), ctx.cache_seq_axes)
    else:
        out = attention(q, k, v, positions, positions, causal=causal)
    if lay.padded:
        out = out * local_head_mask(lay, m, out.device)[:, None].to(
            out.dtype)
    out = linear(p[prefix + "wo.w"], out.reshape(b, s, lay.L * hd), ctx)
    return tp_reduce(out, ctx)


def dense_block_apply(p: dict, x: torch.Tensor, positions: torch.Tensor,
                      cfg, ctx: ShardCtx,
                      mrope_positions: "torch.Tensor | None" = None,
                      step: StepState = TRAIN, cache: "dict | None" = None
                      ) -> torch.Tensor:
    x = x + attn_apply(p, rmsnorm(sp_shared(p["ln1.scale"], ctx), x,
                                  cfg.norm_eps),
                       positions, cfg, ctx,
                       mrope_positions=mrope_positions, step=step,
                       cache=cache)
    return x + mlp_apply(p, rmsnorm(sp_shared(p["ln2.scale"], ctx), x,
                                    cfg.norm_eps), ctx)


def lm_logits(final_scale: torch.Tensor, table: torch.Tensor,
              x: torch.Tensor, cfg, ctx: ShardCtx) -> torch.Tensor:
    """x: (B, S, d) -> the vocabulary-parallel logits (B, S, V/tp): the
    final norm, then this rank's rows of the table."""
    x = tp_copy(rmsnorm(sp_shared(final_scale, ctx), x, cfg.norm_eps), ctx)
    return unembed_logits(table, x, ctx)


def _chunk_loss(table: torch.Tensor, xb: torch.Tensor, lb: torch.Tensor,
                ctx: ShardCtx, vocab: int) -> torch.Tensor:
    with record_function(LM_LOSS):
        logits = unembed_logits(table, xb, ctx)
        per_tok = vocab_parallel_xent(logits, lb.clamp(min=0), ctx, vocab)
        return (per_tok * (lb >= 0)).sum()


def lm_loss(final_scale: torch.Tensor, table: torch.Tensor, x: torch.Tensor,
            labels: torch.Tensor, cfg, ctx: ShardCtx,
            xent_chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded LM loss: the logits are produced and consumed one
    sequence chunk at a time, each chunk recomputed in the backward pass,
    so peak memory holds one chunk of logits.  labels < 0 are masked out,
    and so are the padded vocabulary columns (``vocab_parallel_xent``).
    Returns (sum of token losses, token count), both local (the same on
    every model rank: the sequence is gathered after the final norm)."""
    x = tp_copy(rmsnorm(sp_shared(final_scale, ctx), x, cfg.norm_eps), ctx)
    s = x.shape[1]
    chunk = min(xent_chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(x.shape[1] // chunk):
        xb = x[:, c * chunk:(c + 1) * chunk]
        lb = labels[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            loss = checkpoint(_chunk_loss, table, xb, lb, ctx, cfg.vocab,
                              use_reentrant=False)
        else:
            loss = _chunk_loss(table, xb, lb, ctx, cfg.vocab)
        total = total + loss
        count = count + (lb >= 0).sum()
    return total, count
