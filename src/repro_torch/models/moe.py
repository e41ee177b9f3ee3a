"""Mixture-of-Experts FFN with expert parallelism over ``model``.
Counterpart of ``repro.models.moe`` (``pad_experts``, ``capacity``,
``_route``, ``_dispatch_indices``, ``_ep_all_to_all``, ``moe_apply``,
``_aux_loss``, ``moe_block_apply``).  At ``ctx.tp == 1`` every expert
lives on every rank and nothing is exchanged.

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

Expert parallelism (``ctx.tp > 1``; the JAX package's training layout,
experts over ``model``): the
experts, padded to ``E_pad``, a multiple of ``tp``, with ``-inf`` router
logits on the padding, are stacked ``(E_pad / tp, ...)`` on each model
rank.  The ``(E_pad, C, d)`` buffer
goes through the ``model`` all-to-all (``_ep_all_to_all``) to
``(E_pad / tp, tp·C, d)``, the local experts run, and the result comes
back the same way.  The shared experts and arctic's dense residual are
TP MLPs (``transformer.mlp_apply``).  Under SP each rank routes its own
slice of the sequence with a capacity of its own (JAX ``moe.py``: the
all-to-all mixes the tokens across ``model`` anyway), the router and
the shared-expert gate are read under ``tp_shared`` (each rank's
gradient covers its tokens), and the load-balancing loss is this rank's
tokens'.  Without SP every model rank routes every token, as in the
JAX package, so each expert receives ``tp`` copies of each token; the
forward is that of ``tp = 1`` and the experts' gradient, summed over the
copies, is scaled by ``1 / tp`` (``layers.grad_scale``) so that it is
the gradient of the loss once (JAX's is ``tp`` times it).

The 2-D serving layout (``ctx.moe_ep_axis == "data"``, arctic's
``serve_moe_ep_data``): the experts are split over ``data`` (``E_pad``
a multiple of the ``data`` size, the same count as at ``tp``), and
within each expert ``gate`` and ``up`` over ``model`` along ``d_ff``
and ``down`` along its ``d_ff`` rows.  Each data rank routes its own
tokens, the buffer goes through the all-to-all over ``data``, each model
rank runs its ``d_ff`` slice of every local expert, and a sum over
``model`` closes the down projection before the exchange back (JAX
``moe_apply``'s ``two_d``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.layers import (ShardCtx, all_to_all, grad_scale,
                                       rmsnorm, sp_shared, tp_reduce)
from repro_torch.models.transformer import (TRAIN, StepState, attn_apply,
                                            mlp_apply)

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


def _ep_all_to_all(buf: torch.Tensor, ep: int, axes: tuple[str, ...],
                   forward: bool) -> torch.Tensor:
    """(E_pad, C, d) <-> (E_pad / ep, ep·C, d) over ``axes``: the leading
    dim of the exchange indexes the destination rank before it and the
    source rank after it."""
    if ep == 1:
        return buf
    if forward:
        e_pad, c, d = buf.shape
        out = all_to_all(buf.reshape(ep, e_pad // ep, c, d), axes)
        return out.transpose(0, 1).reshape(e_pad // ep, ep * c, d)
    e_local, epc, d = buf.shape
    c = epc // ep
    out = all_to_all(buf.reshape(e_local, ep, c, d).transpose(0, 1), axes)
    return out.reshape(e_local * ep, c, d)


def moe_apply(p: dict, x: torch.Tensor, cfg, ctx: ShardCtx):
    """x: (B, S, d), the normed block input (this rank's slice of the
    sequence under SP).  Returns (the MoE output of x's shape and dtype,
    the load-balancing loss).  ``p`` holds one layer's leaves under
    ``blocks.`` (``"moe.router"``, ``"moe.experts.gate"``, ...), the
    experts this rank's ``(E_pad / ep, ...)`` (and, in the 2-D layout,
    its ``d_ff`` slice of each).  The caller adds the residual."""
    if ctx.moe_ep_axis:
        axes = (ctx.moe_ep_axis,)
        ep = mesh_mod.size(axes)
    else:
        axes, ep = ("model",), ctx.tp
    two_d = axes != ("model",) and ctx.tp > 1
    mc = cfg.moe
    b, s, d = x.shape
    t, k = b * s, mc.top_k
    e_pad = pad_experts(mc.n_experts, ep)
    cap = capacity(t, k, e_pad, ep, mc.capacity_factor)
    cd = ctx.compute_dtype

    xt = x.reshape(t, d)
    with record_function(DISPATCH):
        probs, top_i, logits = _route(sp_shared(p["moe.router"], ctx), xt,
                                      mc, e_pad)
        expert_of, slot_of, keep = _dispatch_indices(top_i, e_pad, cap)
        # each token to its k slots; dropped ones to the spare slot cap
        src = xt.to(cd)[:, None, :].expand(t, k, d).reshape(t * k, d)
        dest = expert_of * (cap + 1) + torch.where(keep, slot_of, cap)
        buf = torch.zeros(e_pad * (cap + 1), d, dtype=cd, device=x.device)
        buf = buf.index_copy(0, dest, src).view(e_pad, cap + 1, d)[:, :cap]

    # ---- the EP exchange and the batched expert SwiGLU
    buf = _ep_all_to_all(buf, ep, axes, True)         # (E_pad/ep, ep·C, d)
    # without SP each expert over model sees ep copies of each token
    dup = 1.0 if ctx.seq_parallel or axes != ("model",) else 1.0 / ep
    w_g, w_u, w_d = (grad_scale(p["moe.experts." + n], dup).to(cd)
                     for n in ("gate", "up", "down"))
    h_g = torch.bmm(buf, w_g)
    h_u = torch.bmm(buf, w_u)
    out = torch.bmm(F.silu(h_g) * h_u, w_d)
    if two_d:       # the row-parallel down projection over model
        out = tp_reduce(out, ctx, seq_parallel=False)
    out = _ep_all_to_all(out, ep, axes, False)        # (E_pad, C, d)

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
        gate = torch.sigmoid(
            x.float() @ sp_shared(p["moe.shared_gate"], ctx).float())
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
                    cfg, ctx: ShardCtx, step: StepState = TRAIN,
                    cache: "dict | None" = None):
    """Pre-norm attention (its cache written in prefill and decode), then
    the pre-norm MoE FFN.  Returns (the block's output, its
    load-balancing loss)."""
    x = x + attn_apply(p, rmsnorm(sp_shared(p["ln1.scale"], ctx), x,
                                  cfg.norm_eps), positions, cfg, ctx,
                       step=step, cache=cache)
    m, aux = moe_apply(p, rmsnorm(sp_shared(p["ln2.scale"], ctx), x,
                                  cfg.norm_eps), cfg, ctx)
    return x + m, aux
