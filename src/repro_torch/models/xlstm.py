"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential scan), Beck et al., 2024.  Counterpart of
``repro.models.xlstm`` (``mlstm_reference``, ``mlstm_chunked``,
``_vh_layout``, ``_slice_heads``, ``mlstm_block_apply``, ``slstm_scan``,
``slstm_block_apply`` and the blocks' parameter layouts); the decode step
and the caches belong to serving and are not here.

mLSTM is a gated linear-attention recurrence with exponential input gates
and a running-max stabiliser.  ``mlstm_chunked`` is the chunkwise form:
within a chunk of ``c`` steps masked products, across chunks a Python
loop carries the state ``(C, n, m)``, stored log-stabilised by its own
``m`` so that every ``exp`` argument stays <= 0.  The per-chunk body runs
under ``torch.utils.checkpoint`` when autograd records it, as the JAX
package puts ``jax.checkpoint`` on it, so the ``(b, c, c, h)`` weights
exist for one chunk at a time.  Every product is a product of two
operands: ``torch.einsum`` without ``opt_einsum`` contracts three
operands left to right, and ``"bth,bhvk,bthk->bthv"`` would first build a
``(b, t, h, v, k)`` tensor (2 GiB a chunk at ``xlstm-350m``'s widths).
The stabilisers ``m`` are detached, as the JAX package stops their
gradients.

sLSTM is a sequential scan over the tokens with recurrent per-head mixing
(``r_gates``).  The state is kept as ``(h, b, hd)`` so that the recurrent
product is one batched matmul a step, and the gate pre-activations are
split per step with one ``unbind`` (whose backward is one stack, where
per-step indexing would write a full-size gradient per step).  The head
maximum is ``torch.amax``, whose gradient splits ties evenly as
``jnp.max``'s does (``max(dim)`` would send it all to one index); it is not
detached, as in the JAX package.  The JAX package puts ``jax.checkpoint``
on each token step; the port does not: the values are the same, the block
runs under its own checkpoint when ``remat="full"``, and the per-step
saved tensors (~80 MB a block at ``xlstm-350m``'s widths, batch 4 x 512)
cost less than a checkpoint's host work on each of 512 steps.

Both scans compute in fp32 whatever the input dtype; the gate
pre-activations come from fp32 products with the fp32 leaves ``w_if`` /
``w_gates`` (``FP32_LEAVES``), the other projections run in the compute
dtype.  ``SLSTM_BF16_RECURRENCE`` (False, as in the JAX package) rounds the
sLSTM gate inputs and recurrent product to bf16.  The scans run inside
the profiler ranges ``MLSTM`` and ``SLSTM``.  A block's parameters arrive
as a dict keyed by their names under ``groups.mlstm.`` or
``groups.slstm.`` (``"up_v.w"``, ``"r_gates"``, ...), one block's slice of
the stacked leaves.

Tensor parallelism (``ctx.tp > 1``).  The mLSTM value dim is
column-sharded as heads x v-parts (``vh_layout``): at ``tp <= n_heads``
each rank holds ``n_heads / tp`` whole heads; past it each head's value
rows (the rows of its ``C``, independent given the head's q, k and
gates) split over ``r = tp / n_heads`` ranks, and the grouped norm's
group is the ``dv / r`` values a rank holds, another function than at
``tp = 1``, as in the JAX package.  q, k and the gates come from
replicated weights read under ``tp_shared`` and are sliced to this
rank's head(s) (``slice_heads``); ``out`` is row-parallel, between
``tp_copy`` and ``tp_reduce``.  The sLSTM block runs replicated over
``model``: without SP every rank computes it whole from the same input
and holds the whole gradient of every leaf and of its input, so it has
no collective; under SP ``tp_copy`` gathers the sequence, every rank
scans all of it, keeps its own tokens' outputs (the global positions
``m S/tp ...``) and runs the FFN on them, so every leaf is read under
``sp_shared``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (ShardCtx, linear, maybe_tp_shared,
                                       rmsnorm, sp_shared, tp_copy,
                                       tp_reduce)
from repro_torch.models.mamba2 import _grouped_rmsnorm, causal_conv
from repro_torch.parallel.collectives import tp_index

NEG = -1e30
#: run the sLSTM recurrent product and gate inputs in bf16 (the state
#: updates stay fp32), as the JAX package's switch of the same name
SLSTM_BF16_RECURRENCE = False
#: the blocks' leaves kept in fp32 whatever the parameter dtype
MLSTM_FP32_LEAVES = ("b_if", "w_if")
SLSTM_FP32_LEAVES = ("b_gates", "r_gates", "w_gates")
#: the profiler ranges around the two scans
MLSTM, SLSTM = "xlstm.mlstm", "xlstm.slstm"


def mlstm_dims(cfg) -> tuple[int, int, int, int]:
    """(d_inner, heads, q/k dim per head, v dim per head)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, cfg.n_heads, cfg.ssm.state_dim, d_inner // cfg.n_heads


def mlstm_layout(cfg, lead: tuple[int, ...], prefix: str) -> list:
    """(name, shape, init) of one mLSTM block's leaves in leaf order, each
    shape behind ``lead``.  ``init`` is a truncated-normal std, None for
    ones, or ``"b_if"`` (zeros for the input gates, ``linspace(3, 6)`` for
    the forget gates)."""
    d, w = cfg.d_model, cfg.ssm.conv_dim
    d_inner, hn, dqk, _ = mlstm_dims(cfg)
    leaves = [("b_if", (2 * hn,), "b_if"),
              ("conv", (w, d), 1 / math.sqrt(w)),
              ("ln", (d,), None), ("norm", (d_inner,), None),
              ("out.w", (d_inner, d), 1 / math.sqrt(d_inner)),
              ("up_v.w", (d, d_inner), 1 / math.sqrt(d)),
              ("up_z.w", (d, d_inner), 1 / math.sqrt(d)),
              ("w_if", (d, 2 * hn), 0.02),
              ("wk", (d, hn * dqk), 1 / math.sqrt(d)),
              ("wq", (d, hn * dqk), 1 / math.sqrt(d))]
    return [(prefix + name, (*lead, *shape), init)
            for name, shape, init in leaves]


def slstm_layout(cfg, lead: tuple[int, ...], prefix: str) -> list:
    """(name, shape, init) of one sLSTM block's leaves in leaf order;
    ``"b_gates"`` is zeros with 3.0 on the forget-gate quarter."""
    d, hn, w = cfg.d_model, cfg.n_heads, cfg.ssm.conv_dim
    hd = d // hn
    leaves = [("b_gates", (4 * d,), "b_gates"),
              ("conv", (w, d), 1 / math.sqrt(w)),
              ("ffn.down", (2 * d, d), 1 / math.sqrt(2 * d)),
              ("ffn.up", (d, 4 * d), 1 / math.sqrt(d)),
              ("ln", (d,), None), ("ln2", (d,), None), ("norm", (d,), None),
              ("r_gates", (4, hn, hd, hd), 1 / math.sqrt(hd)),
              ("w_gates", (d, 4 * d), 1 / math.sqrt(d))]
    return [(prefix + name, (*lead, *shape), init)
            for name, shape, init in leaves]


def b_if_init(n_heads: int) -> torch.Tensor:
    """The mLSTM gate bias: zeros for the input gates, then
    ``linspace(3, 6, n_heads)`` for the forget gates, in fp32."""
    return torch.cat([torch.zeros(n_heads, dtype=torch.float64),
                      torch.linspace(3.0, 6.0, n_heads,
                                     dtype=torch.float64)]).float()


def b_gates_init(d: int) -> torch.Tensor:
    """The sLSTM gate bias (z, i, f, o quarters of ``d``): 3.0 on the
    forget gates, zeros elsewhere, in fp32."""
    out = torch.zeros(4 * d, dtype=torch.float32)
    out[2 * d:3 * d] = 3.0
    return out


# --------------------------------------------------------------------------
# mLSTM cell
# --------------------------------------------------------------------------
def _zero_carry(q: torch.Tensor, dv: int):
    b, _, h, dk = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros(b, h, dv, dk, **f32), torch.zeros(b, h, dk, **f32),
            torch.full((b, h), NEG, **f32))


def mlstm_reference(q, k, v, i_gate, f_gate, carry=None):
    """Sequential oracle.  q, k: (b, l, h, dk); v: (b, l, h, dv); i_gate,
    f_gate: (b, l, h) pre-activations.  Returns (y (b, l, h, dv), carry
    ``(C, n, m)``), fp32."""
    dk = q.shape[-1]
    C, n, m = carry if carry is not None else _zero_carry(q, v.shape[-1])
    q = q.float() / math.sqrt(dk)
    k, v, i_gate, f_gate = (t.float() for t in (k, v, i_gate, f_gate))
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt, it = q[:, t], k[:, t], v[:, t], i_gate[:, t]
        log_f = F.logsigmoid(f_gate[:, t])                  # (b,h)
        m_new = torch.maximum(log_f + m, it)
        fp = torch.exp(log_f + m - m_new)
        ip = torch.exp(it - m_new)
        C = fp[..., None, None] * C \
            + ip[..., None, None] * (vt[..., :, None] * kt[..., None, :])
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.einsum("bhk,bhk->bh", n, qt).abs()
        den = torch.maximum(den, torch.exp(-m_new))
        ys.append(num / den[..., None])
        m = m_new
    return torch.stack(ys, dim=1), (C, n, m)


def _mlstm_chunk(C, n, m_c, qk, kk, vk, sk, ik):
    """One chunk: carry C (b,h,dv,dk), n (b,h,dk), m_c (b,h); qk, kk
    (b,c,h,dk); vk (b,c,h,dv); sk (inclusive log-forget cumsum), ik
    (b,c,h).  Returns (C, n, m) after the chunk and the chunk's y."""
    c = sk.shape[1]
    tri = torch.ones(c, c, dtype=torch.bool, device=sk.device).tril()
    # weight of (v_i k_i) in C_t: exp(s_t - s_i + i_i) for i <= t
    wk = sk[:, :, None, :] - sk[:, None, :, :] + ik[:, None, :, :]
    wk = torch.where(tri[None, :, :, None], wk, NEG)        # (b,t,i,h)
    b_t = sk + m_c[:, None, :]                              # (b,c,h)
    m_loc = torch.maximum(wk.amax(dim=2), b_t).detach()
    wn = torch.exp(wk - m_loc[:, :, None, :])               # (b,t,i,h)
    bn = torch.exp(b_t - m_loc)                             # (b,c,h)
    sw = torch.einsum("bthk,bihk->btih", qk, kk) * wn
    qb = qk * bn[..., None]                                 # (b,c,h,dk)
    num = torch.einsum("btih,bihv->bthv", sw, vk) \
        + torch.einsum("bthk,bhvk->bthv", qb, C)
    den = sw.sum(dim=2) + torch.einsum("bthk,bhk->bth", qb, n)
    den = torch.maximum(den.abs(), torch.exp(-m_loc))
    y = num / den[..., None]
    # ---- the carry at the end of the chunk ----
    s_last = sk[:, -1, :]                                   # (b,h)
    w_end = s_last[:, None, :] - sk + ik                    # (b,c,h)
    m_new = torch.maximum(m_c + s_last, w_end.amax(dim=1)).detach()
    w_end_n = torch.exp(w_end - m_new[:, None, :])
    decay = torch.exp(m_c + s_last - m_new)
    C = decay[..., None, None] * C + torch.einsum(
        "bchv,bchk->bhvk", vk * w_end_n[..., None], kk)
    n = decay[..., None] * n + torch.einsum("bch,bchk->bhk", w_end_n, kk)
    return C, n, m_new, y


def mlstm_chunked(q, k, v, i_gate, f_gate, chunk: int, carry=None):
    """Chunkwise mLSTM.  Shapes as ``mlstm_reference``; fp32 inside.  ``l``
    is padded up to a multiple of ``c = min(chunk, l)`` (no input, the
    state kept) and the padding cut off the output."""
    b, l, h, dk = q.shape
    dv = v.shape[-1]
    C, n, m = carry if carry is not None else _zero_carry(q, dv)
    c = min(chunk, l)
    pad = (-l) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_gate = F.pad(i_gate, (0, 0, 0, pad), value=NEG)
        f_gate = F.pad(f_gate, (0, 0, 0, pad), value=30.0)
    nc = q.shape[1] // c
    qc = (q.float() / math.sqrt(dk)).reshape(b, nc, c, h, dk)
    kc = k.float().reshape(b, nc, c, h, dk)
    vc = v.float().reshape(b, nc, c, h, dv)
    ic = i_gate.float().reshape(b, nc, c, h)
    s = torch.cumsum(F.logsigmoid(f_gate.float()).reshape(b, nc, c, h),
                     dim=2)
    remat = torch.is_grad_enabled()
    ys = []
    for j in range(nc):
        args = (C, n, m, qc[:, j], kc[:, j], vc[:, j], s[:, j], ic[:, j])
        C, n, m, y = checkpoint(_mlstm_chunk, *args, use_reentrant=False) \
            if remat else _mlstm_chunk(*args)
        ys.append(y)
    y = ys[0] if nc == 1 else torch.cat(ys, dim=1)
    return y[:, :l], (C, n, m)


def vh_layout(n_heads: int, dv: int, tp: int) -> tuple[int, int, int]:
    """(heads a rank holds, values a rank holds per head, ``r``) of the
    heads x v-parts split over ``tp`` ranks (JAX ``_vh_layout``): whole
    heads while ``tp <= n_heads``, else one head's ``dv / r`` values,
    ``r = tp / n_heads`` ranks to a head.  ``ValueError`` when neither
    divides."""
    if tp <= n_heads:
        if n_heads % tp:
            raise ValueError(f"{n_heads} mLSTM heads over tp={tp}")
        return n_heads // tp, dv, 1
    r = tp // n_heads
    if tp % n_heads or dv % r:
        raise ValueError(f"{n_heads} mLSTM heads of {dv} values over "
                         f"tp={tp}")
    return 1, dv // r, r


def slice_heads(t: torch.Tensor, hn: int, ctx: ShardCtx) -> torch.Tensor:
    """(B, S, hn, ...) computed for every head -> this model rank's heads
    along dim 2: its ``hn / tp``, or past ``tp = hn`` the one head its
    v-part belongs to (JAX ``_slice_heads``); ``t`` itself at ``tp =
    1``."""
    if ctx.tp <= 1:
        return t
    if ctx.tp <= hn:
        per = hn // ctx.tp
        return t.narrow(2, tp_index() * per, per)
    return t.narrow(2, tp_index() // (ctx.tp // hn), 1)


def mlstm_block_apply(p: dict, x: torch.Tensor, cfg,
                      ctx: ShardCtx) -> torch.Tensor:
    """Pre-norm mLSTM block.  x: (B, S, d) in the compute dtype (this
    rank's slice of the sequence under SP); returns ``x +
    out(norm(mlstm(...)) * silu(z))``, on this rank's heads x v-parts
    under TP."""
    _, hn, dqk, dv = mlstm_dims(cfg)
    h_loc, v_loc, _ = vh_layout(hn, dv, ctx.tp)
    h = rmsnorm(sp_shared(p["ln"], ctx), x, cfg.norm_eps)
    h = tp_copy(h, ctx)                          # the whole sequence
    b, s, _ = h.shape
    v = linear(p["up_v.w"], h, ctx)                         # (B,S,d_in/tp)
    z = linear(p["up_z.w"], h, ctx)
    hc = causal_conv(h, maybe_tp_shared(p["conv"], ctx))
    q = linear(maybe_tp_shared(p["wq"], ctx), hc, ctx).reshape(b, s, hn, dqk)
    k = linear(maybe_tp_shared(p["wk"], ctx), hc, ctx).reshape(b, s, hn, dqk)
    gif = h.float() @ maybe_tp_shared(p["w_if"], ctx).float() \
        + maybe_tp_shared(p["b_if"], ctx).float()
    q, k = slice_heads(q, hn, ctx), slice_heads(k, hn, ctx)
    ig = slice_heads(gif[..., :hn, None], hn, ctx)[..., 0]
    fg = slice_heads(gif[..., hn:, None], hn, ctx)[..., 0]
    with record_function(MLSTM):
        y, _ = mlstm_chunked(q, k, v.reshape(b, s, h_loc, v_loc), ig, fg,
                             cfg.ssm.chunk)
    y = y.reshape(b, s, h_loc * v_loc).to(ctx.compute_dtype)
    y = _grouped_rmsnorm(p["norm"], y, z, v_loc, cfg.norm_eps)
    return x + tp_reduce(linear(p["out.w"], y, ctx), ctx)


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def slstm_scan(gates_x: torch.Tensor, r_gates: torch.Tensor, hn: int,
               h0=None):
    """gates_x: (b, l, 4, hn, hd) input-driven pre-activations (z, i, f,
    o); r_gates: (4, hn, hd, hd).  The sequential scan with recurrent
    per-head mixing ``rec[g, b, h, i] = sum_j r[g, h, i, j] hprev[b, h,
    j]``.  Returns (y (b, l, hn, hd), carry ``(c, n, h, m)``, the first
    three (b, hn, hd), ``m`` (b, hn)), fp32."""
    b, _, _, _, hd = gates_x.shape
    f32 = torch.float32
    if SLSTM_BF16_RECURRENCE:
        gates_x = gates_x.to(torch.bfloat16)
        r_gates = r_gates.to(torch.bfloat16)
        rec_dt = torch.bfloat16
    else:
        rec_dt = f32
    # per step (hn, b, 4, hd) pre-activations; r as (hn, j, 4 * hd)
    steps = gates_x.permute(1, 3, 0, 2, 4).float().contiguous().unbind(0)
    r = r_gates.to(rec_dt).permute(1, 3, 0, 2).reshape(hn, hd, 4 * hd)
    if h0 is None:
        zeros = gates_x.new_zeros((hn, b, hd), dtype=f32)
        c, n, hprev = zeros, zeros, zeros
        m = torch.full((hn, b), NEG, dtype=f32, device=gates_x.device)
    else:
        c, n, hprev = (t.float().transpose(0, 1) for t in h0[:3])
        m = h0[3].float().transpose(0, 1)
    # jnp.maximum(n, 1.0): a tie (n == 1 exactly, common at the first
    # step) gives half the gradient to each side, as torch.maximum does
    one = torch.ones((), dtype=f32, device=gates_x.device)
    ys = []
    for gx in steps:
        rec = torch.bmm(hprev.to(rec_dt), r).to(f32).view(hn, b, 4, hd)
        pre = gx + rec
        zt = torch.tanh(pre[:, :, 0])
        it = pre[:, :, 1]
        log_f = F.logsigmoid(pre[:, :, 2])
        ot = torch.sigmoid(pre[:, :, 3])
        m_head = torch.maximum(log_f + m[..., None], it).amax(dim=-1)
        fp = torch.exp(log_f + (m - m_head)[..., None])
        ip = torch.exp(it - m_head[..., None])
        c = fp * c + ip * zt
        n = fp * n + ip
        hprev = ot * c / torch.maximum(n, one)
        m = m_head
        ys.append(hprev)
    y = torch.stack(ys).permute(2, 0, 1, 3)                 # (b,l,hn,hd)
    carry = tuple(t.transpose(0, 1) for t in (c, n, hprev, m))
    return y, carry


def slstm_block_apply(p: dict, x: torch.Tensor, cfg,
                      ctx: ShardCtx) -> torch.Tensor:
    """Pre-norm sLSTM block, then the gated FFN (``gelu`` in its tanh
    form, as ``jax.nn.gelu``'s default).  x: (B, S, d) in the compute
    dtype.  Replicated over ``model``; under SP ``x`` is this rank's
    slice of the sequence, the scan runs over the gathered whole and its
    output is sliced back to this rank's tokens."""
    d, hn = cfg.d_model, cfg.n_heads
    sp = ctx.tp > 1 and ctx.seq_parallel
    if sp:
        p = {name: sp_shared(w, ctx) for name, w in p.items()}
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    if sp:
        h = tp_copy(h, ctx)                      # the whole sequence
    b, s, _ = h.shape
    hc = causal_conv(h, p["conv"])
    wg, bg = p["w_gates"].float(), p["b_gates"].float()
    # i/f gates see the conv path, z/o the direct path (xLSTM paper)
    gx = h.float() @ wg + bg
    gxc = hc.float() @ wg + bg
    gates = torch.stack([gx[..., :d], gxc[..., d:2 * d],
                         gxc[..., 2 * d:3 * d], gx[..., 3 * d:]], dim=2)
    gates = gates.reshape(b, s, 4, hn, d // hn)
    with record_function(SLSTM):
        y, _ = slstm_scan(gates, p["r_gates"], hn)
    y = y.reshape(b, s, d).to(ctx.compute_dtype)
    if sp:                                       # this rank's tokens
        n = s // ctx.tp
        y = y.narrow(1, tp_index() * n, n)
    x = x + rmsnorm(p["norm"], y, cfg.norm_eps)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    a, g = linear(p["ffn.up"], h2, ctx).chunk(2, dim=-1)
    return x + linear(p["ffn.down"], F.gelu(a, approximate="tanh") * g, ctx)
