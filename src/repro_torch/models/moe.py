"""Mixture-of-Experts FFN at expert-parallel degree 1.  Counterpart of
``repro.models.moe`` (``pad_experts``, ``capacity``, ``_route``,
``_dispatch_indices``, ``moe_apply``, ``_aux_loss``, ``moe_block_apply``)
without the expert-parallel ``all_to_all``: the port has no TP axis, so
every expert lives on every rank.

Routing is top-k softmax over fp32 router logits, renormalised over the
k picks, with a fixed per-expert capacity; a token's pick beyond its
expert's capacity is dropped (it contributes nothing, and the residual
carries the token on).  Dispatch is slot-based, with no ``(T, E, C)``
one-hot of the tokens:

    1. top-k expert ids per token -> the flat ``(T·k,)`` assignment list
    2. each assignment's rank within its expert, in token order (the
       position ``jnp.argsort(stable=True)`` gives it in the JAX package)
    3. the tokens copied into an ``(E, C, d)`` buffer (dropped ones into a
       spare slot ``C`` that is sliced off)
    4. the batched expert SwiGLU (``torch.bmm`` over the experts; the JAX
       package's ``jnp.einsum``, not a Pallas kernel)
    5. each assignment's slot read back and weighted by its router
       probability, the k picks of a token summed

The routing and dispatch (1-3) and the combine (5) run inside the
profiler ranges ``DISPATCH`` and ``COMBINE``.  The layer issues no host
synchronisation: every size is a Python int from the config and the batch
shape, and the slots come from a cumulative sum over a ``(T·k, E)``
indicator, not from ``bincount``, ``nonzero`` or a boolean mask.  Its
backward is deterministic: the token gather of step 3 is an ``expand`` of
``(T, 1, d)`` to ``(T, k, d)`` and the combine of step 5 a sum over the
``k`` axis of a ``(T, k, d)`` view, so neither has a scatter-add
backward; the slot writes and reads move each kept value once, and a
dropped assignment's value is zero.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import ShardCtx, rmsnorm
from repro_torch.models.transformer import attn_apply, mlp_apply

#: the ``blocks.`` leaves the MoE layer keeps in fp32 whatever the
#: parameter dtype, as the JAX package draws them
FP32_LEAVES = ("moe.router", "moe.shared_gate")
#: the profiler ranges around the routing and dispatch, and the combine
DISPATCH, COMBINE = "moe.dispatch", "moe.combine"


def pad_experts(n_experts: int, ep: int) -> int:
    return -(-n_experts // ep) * ep


def capacity(tokens_local: int, top_k: int, e_pad: int, ep: int,
             factor: float) -> int:
    """Per-expert, per-source-rank slot count, a multiple of 8."""
    c = math.ceil(tokens_local * top_k / e_pad * factor)
    return max(8, -(-c // 8) * 8)


def _route(router_w: torch.Tensor, x: torch.Tensor, mc, e_pad: int):
    """x: (T, d) -> (top-k probabilities (T, k) renormalised over the k
    picks, expert ids (T, k) int64, fp32 logits (T, E)); the router math
    runs in fp32."""
    logits = x.float() @ router_w.float()
    if e_pad > mc.n_experts:
        pad = torch.arange(e_pad, device=x.device) >= mc.n_experts
        logits = logits.masked_fill(pad[None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, mc.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i, logits


def _dispatch_indices(top_i: torch.Tensor, e_pad: int, cap: int):
    """Slot assignment of the flat ``(T·k,)`` list: per assignment its
    expert id, its slot (its rank among the assignments to that expert, in
    flat order) and whether that slot is within ``cap``."""
    flat_e = top_i.reshape(-1)
    hit = torch.zeros(flat_e.shape[0], e_pad, dtype=torch.int32,
                      device=top_i.device)
    hit.scatter_(1, flat_e[:, None], 1)
    # the running count of each expert's assignments, read at the own one
    slot_of = hit.cumsum(0).gather(1, flat_e[:, None])[:, 0] - 1
    return flat_e, slot_of.long(), slot_of < cap


def moe_apply(p: dict, x: torch.Tensor, cfg, ctx: ShardCtx):
    """x: (B, S, d), the normed block input.  Returns (the MoE output of
    x's shape and dtype, the load-balancing loss).  ``p`` holds one layer's
    leaves under ``blocks.`` (``"moe.router"``, ``"moe.experts.gate"``,
    ...).  The caller adds the residual."""
    ep = 1                     # every expert on every rank: no TP axis
    mc = cfg.moe
    b, s, d = x.shape
    t, k = b * s, mc.top_k
    e_pad = pad_experts(mc.n_experts, ep)
    cap = capacity(t, k, e_pad, ep, mc.capacity_factor)
    cd = ctx.compute_dtype

    xt = x.reshape(t, d)
    with record_function(DISPATCH):
        probs, top_i, logits = _route(p["moe.router"], xt, mc, e_pad)
        expert_of, slot_of, keep = _dispatch_indices(top_i, e_pad, cap)
        # each token to its k slots; dropped ones to the spare slot cap
        src = xt.to(cd)[:, None, :].expand(t, k, d).reshape(t * k, d)
        dest = expert_of * (cap + 1) + torch.where(keep, slot_of, cap)
        buf = torch.zeros(e_pad * (cap + 1), d, dtype=cd, device=x.device)
        buf = buf.index_copy(0, dest, src).view(e_pad, cap + 1, d)[:, :cap]

    # ---- the batched expert SwiGLU
    h_g = torch.bmm(buf, p["moe.experts.gate"].to(cd))
    h_u = torch.bmm(buf, p["moe.experts.up"].to(cd))
    out = torch.bmm(F.silu(h_g) * h_u, p["moe.experts.down"].to(cd))

    with record_function(COMBINE):
        # the slots back to their tokens, weighted by the router
        src_slot = expert_of * cap + torch.clamp(slot_of, max=cap - 1)
        gathered = out.reshape(e_pad * cap, d).index_select(0, src_slot)
        w = probs.reshape(-1) * keep
        combined = (gathered.float() * w[:, None]).view(t, k, d).sum(1)
        y = combined.reshape(b, s, d).to(x.dtype)

    # ---- shared experts behind a sigmoid gate / the dense residual
    if mc.n_shared:
        sh = mlp_apply(p, x, ctx, prefix="moe.shared.")
        gate = torch.sigmoid(x.float() @ p["moe.shared_gate"].float())
        y = y + sh * gate.to(x.dtype)
    if mc.dense_residual:
        y = y + mlp_apply(p, x, ctx, prefix="moe.dense.")
    return y, _aux_loss(logits, top_i, e_pad)


def _aux_loss(logits: torch.Tensor, top_i: torch.Tensor,
              e_pad: int) -> torch.Tensor:
    """Switch-style load-balancing loss over the local tokens."""
    me = torch.softmax(logits, dim=-1).mean(0)
    hits = torch.zeros(e_pad, dtype=torch.float32, device=logits.device)
    hits.scatter_add_(0, top_i.reshape(-1),
                      torch.ones(top_i.numel(), device=logits.device))
    ce = hits / torch.clamp(hits.sum(), min=1.0)
    return e_pad * (me * ce).sum()


def moe_block_apply(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg, ctx: ShardCtx):
    """Pre-norm attention, then the pre-norm MoE FFN.  Returns (the
    block's output, its load-balancing loss)."""
    x = x + attn_apply(p, rmsnorm(p["ln1.scale"], x, cfg.norm_eps),
                       positions, cfg, ctx)
    m, aux = moe_apply(p, rmsnorm(p["ln2.scale"], x, cfg.norm_eps), cfg,
                       ctx)
    return x + m, aux
