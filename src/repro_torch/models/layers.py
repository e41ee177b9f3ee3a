"""Primitive layers of the decoder families.  Counterpart of
``repro.models.layers``.

Weights are laid out ``(d_in, d_out)`` and applied as ``x @ w``, as in the
JAX package.  Parameters are stored in ``ShardCtx.param_dtype`` (fp32,
or bf16 working copies under ZeRO-1 and ``param_dtype="bfloat16"``) and
cast to ``ShardCtx.compute_dtype`` at use; norms, rotary angles, softmax
and the loss run in fp32.

FSDP (HSDP): with ``ShardCtx.fsdp_axes`` set, a sharded weight holds this
rank's slice along one dim (``models.model.param_dims``) and is gathered
at use by :func:`fsdp_gather`, after the cast to the compute dtype, as
the JAX package casts before it gathers.  The gather is an autograd
function whose backward is the reduce-scatter of the cotangent along the
same dim: the ZeRO-3 gradient reduction.  ``gather_quant="int8"`` sends
each shard as symmetric int8 with one fp32 scale (JAX
``_mk_quantized_gather``); its backward stays the plain reduce-scatter.

Tensor parallelism (``ShardCtx.tp > 1``, the ``model`` axis): the
Megatron f/g pairs are autograd functions over the ``model`` group
(``parallel.collectives``).  ``tp_copy`` enters the TP region (identity
forward, sum backward; under ``seq_parallel`` the sequence all-gather
forward and its reduce-scatter backward); ``tp_reduce`` leaves it (the
sum forward, identity backward; under ``seq_parallel`` the sequence
reduce-scatter forward and its all-gather backward); ``tp_shared`` wraps
a leaf replicated over ``model`` whose gradient each rank computes only
in part (identity forward, sum backward).  Every model rank computes the
whole loss and differentiates its own copy: with these pairs each
gradient is that of the loss, once.  The vocabulary-parallel
cross-entropy ends its sums with the same identity-backward sum (where
the JAX package's raw ``psum`` transposes to a second sum over
``model``, which is where its gradients pick up a factor of ``tp``).
Column-parallel weights are sharded over ``model`` on their output dim,
row-parallel ones and the vocabulary tables on their input (first) dim,
the MoE experts on the expert dim, the hybrid and ssm families' leaves
by their names under ``groups.`` (``tp_dim``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.parallel import collectives as coll


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    #: the mesh axes the parameters are sharded over (FSDP); () = none
    fsdp_axes: tuple[str, ...] = ()
    #: "int8" quantizes the FSDP parameter all-gather; None = plain
    gather_quant: "str | None" = None
    #: the size of the ``model`` axis (tensor and expert parallelism)
    tp: int = 1
    #: Megatron sequence parallelism: activations between the TP regions
    #: are sharded over the sequence dim (only with ``tp > 1``)
    seq_parallel: bool = False
    #: serving's context parallelism: the mesh axes the KV cache is
    #: sharded over along its sequence dim; () = none
    cache_seq_axes: tuple[str, ...] = ()
    #: the MoE expert-parallel axis: None = ``model`` (training); "data"
    #: = the 2-D serving layout (experts over ``data``, ``d_ff`` over
    #: ``model``)
    moe_ep_axis: "str | None" = None


def _int8_gather(w: torch.Tensor, axes: tuple[str, ...], axis: int
                 ) -> torch.Tensor:
    """Symmetric int8 with one scale per shard, ``max|w| / 127 + 1e-30``:
    the int8 values and the fp32 scales gathered, each shard dequantized
    in fp32, tiled along ``axis`` and cast to ``w``'s dtype."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel.commplan import _all_gather_single
    w32 = w.float()
    scale = w32.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    p = mesh_mod.size(axes)
    group = mesh_mod.group(axes)
    qg = torch.empty(p * q.numel(), dtype=torch.int8, device=w.device)
    _all_gather_single(qg, q.reshape(-1).contiguous(), group=group)
    sg = torch.empty(p, dtype=torch.float32, device=w.device)
    _all_gather_single(sg, scale.reshape(1), group=group)
    deq = qg.reshape(p, *q.shape).float() \
        * sg.reshape((-1,) + (1,) * w.ndim)
    return torch.cat(deq.unbind(0), dim=axis).to(w.dtype)


class _FsdpGather(torch.autograd.Function):
    """Forward: the all-gather of a shard along ``axis`` (int8 under
    ``quant``); backward: the reduce-scatter of the cotangent along the
    same axis, run once per use of the gathered weight (a recomputed
    forward gathers again and builds a node of its own)."""

    @staticmethod
    def forward(ctx, w, axes, axis, quant):
        ctx.axes, ctx.axis = axes, axis
        if quant:
            return _int8_gather(w, axes, axis)
        return coll.all_gather(w, axes, axis)

    @staticmethod
    def backward(ctx, g):
        return coll.reduce_scatter(g, ctx.axes, ctx.axis), None, None, None


def fsdp_gather(w: torch.Tensor, ctx: ShardCtx, axis: int = 0
                ) -> torch.Tensor:
    """``w``'s shard gathered along ``axis`` over ``ctx.fsdp_axes`` (``w``
    itself without FSDP axes), int8 on the wire under
    ``gather_quant="int8"`` for float weights of two dims or more."""
    if not ctx.fsdp_axes:
        return w
    quant = ctx.gather_quant == "int8" and w.ndim >= 2 \
        and w.dtype in (torch.bfloat16, torch.float32)
    if ctx.gather_quant not in (None, "int8"):
        raise ValueError(f"gather_quant={ctx.gather_quant!r}")
    return _FsdpGather.apply(w, tuple(ctx.fsdp_axes), axis % w.ndim, quant)


# --------------------------------------------------------------------------
# Megatron f/g pairs over the ``model`` axis
# --------------------------------------------------------------------------
class _TpCopy(torch.autograd.Function):
    """Enter the TP region: identity (or the sequence all-gather under
    SP) forward; the sum (or the sequence reduce-scatter) backward."""

    @staticmethod
    def forward(ctx, x, sp, seq_axis):
        ctx.sp, ctx.seq_axis = sp, seq_axis
        return coll.all_gather_tp(x, seq_axis) if sp else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.sp:
            return coll.reduce_scatter_tp(g, ctx.seq_axis), None, None
        return coll.psum_tp(g), None, None


class _TpReduce(torch.autograd.Function):
    """Leave the TP region: the sum (or the sequence reduce-scatter
    under SP) forward; identity (or the sequence all-gather) backward."""

    @staticmethod
    def forward(ctx, x, sp, seq_axis):
        ctx.sp, ctx.seq_axis = sp, seq_axis
        return coll.reduce_scatter_tp(x, seq_axis) if sp \
            else coll.psum_tp(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.sp:
            return coll.all_gather_tp(g, ctx.seq_axis), None, None
        return g, None, None


class _TpShared(torch.autograd.Function):
    """A leaf replicated over ``model`` that each rank reads on its own
    part of the work: identity forward, the sum of the partial gradients
    backward."""

    @staticmethod
    def forward(ctx, w):
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return coll.psum_tp(g)


class _GradScale(torch.autograd.Function):
    """Identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, w, scale):
        ctx.scale = scale
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _AllToAll(torch.autograd.Function):
    """``collectives.all_to_all`` over ``axes`` forward; the same
    exchange, which is its own inverse, backward."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return coll.all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        return coll.all_to_all(g, ctx.axes), None


def tp_copy(x: torch.Tensor, ctx: ShardCtx, seq_axis: int = 1
            ) -> torch.Tensor:
    if ctx.tp == 1:
        return x
    return _TpCopy.apply(x, ctx.seq_parallel, seq_axis)


def tp_reduce(x: torch.Tensor, ctx: ShardCtx, seq_axis: int = 1,
              seq_parallel: "bool | None" = None) -> torch.Tensor:
    """The sum over ``model`` of partial results (reduce-scattered over
    the sequence under SP; ``seq_parallel=False`` forces the plain sum)."""
    if ctx.tp == 1:
        return x
    sp = ctx.seq_parallel if seq_parallel is None else seq_parallel
    return _TpReduce.apply(x, sp, seq_axis)


def maybe_tp_shared(w: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    return _TpShared.apply(w) if ctx.tp > 1 else w


def sp_shared(w: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """``tp_shared`` for a leaf read on the sequence-sharded activations
    of SP (the block and final norms): each rank's gradient covers its
    own tokens.  ``w`` itself without SP, where every rank reads every
    token and has the whole gradient."""
    return _TpShared.apply(w) if ctx.tp > 1 and ctx.seq_parallel else w


def grad_scale(w: torch.Tensor, scale: float) -> torch.Tensor:
    return _GradScale.apply(w, scale) if scale != 1.0 else w


def all_to_all(x: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
    return _AllToAll.apply(x, tuple(axes))


# --------------------------------------------------------------------------
# GQA head layout over ``model`` (JAX ``layers.HeadLayout``)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HeadLayout:
    n_heads: int          # logical q heads
    kv_heads: int         # logical kv heads
    head_dim: int
    tp: int
    L: int                # q heads per rank (padded layout)
    g: int                # logical q heads per kv group
    g_pad: int            # padded group size
    n_h_pad: int          # padded total q heads
    kv_local: int         # kv heads held per rank
    kv_replicated: bool   # kv weights replicated over model, sliced

    @property
    def padded(self) -> bool:
        return self.n_h_pad != self.n_heads


def head_layout(n_heads: int, kv_heads: int, head_dim: int,
                tp: int) -> HeadLayout:
    """The JAX package's layout: with ``kv_heads >= tp`` each rank holds
    ``n_heads / tp`` q heads and ``kv_heads / tp`` kv heads; otherwise the
    kv weights are replicated and each rank reads its group's head, the q
    heads padded per group so that every rank holds ``L`` of one group."""
    if n_heads % kv_heads:
        raise ValueError(f"n_heads={n_heads} kv_heads={kv_heads}")
    g = n_heads // kv_heads
    if kv_heads >= tp:
        if kv_heads % tp or n_heads % tp:
            raise ValueError(f"heads {n_heads}/{kv_heads} over tp={tp}")
        return HeadLayout(n_heads, kv_heads, head_dim, tp, L=n_heads // tp,
                          g=g, g_pad=g, n_h_pad=n_heads,
                          kv_local=kv_heads // tp, kv_replicated=False)
    if tp % kv_heads:
        raise ValueError(f"tp={tp} kv_heads={kv_heads}")
    r = tp // kv_heads
    L = -(-n_heads // tp)
    g_pad = L * (-(-g // L))
    if g_pad // L != r:
        raise ValueError(f"unsupported GQA layout n={n_heads} "
                         f"kv={kv_heads} tp={tp}")
    return HeadLayout(n_heads, kv_heads, head_dim, tp, L=L, g=g,
                      g_pad=g_pad, n_h_pad=g_pad * kv_heads, kv_local=1,
                      kv_replicated=True)


def local_head_mask(lay: HeadLayout, m: int,
                    device=None) -> torch.Tensor:
    """(L,) bool: which of model rank ``m``'s padded q heads are real."""
    idx = m * lay.L + torch.arange(lay.L, device=device)
    return (idx % lay.g_pad) < lay.g


def local_kv_slice(kv: torch.Tensor, lay: HeadLayout, m: int
                   ) -> torch.Tensor:
    """kv: (B, S, kv_heads, hd), whole (the replicated case) -> model rank
    ``m``'s head, (B, S, 1, hd); ``kv`` itself otherwise."""
    if not lay.kv_replicated:
        return kv
    head = m // (lay.tp // lay.kv_heads)
    return kv.narrow(2, head, 1)


#: the weights of a column linear ``(d_in, d_out)`` (and the other
#: leaves FSDP shards on their second-to-last dim) and of a row linear
#: (sharded on their last dim), by the last part of the leaf's name
#: before ``.w``
_COLUMN = frozenset(["wq", "wk", "wv", "gate", "up", "fc1", "in_x", "in_z",
                     "up_v", "up_z"])
_ROW = frozenset(["wo", "down", "fc2", "out"])


def fsdp_dim(name: str) -> "int | None":
    """The dim, counted from the end, along which FSDP shards the leaf
    ``name`` (the JAX package's ``PartitionSpec`` at tensor-parallel
    degree 1): -2 for column linears, the MoE experts, the Mamba2
    ``in_bc``/``in_dt``, the mLSTM ``wq``/``wk`` and the LoRA ``a``; -1
    for row linears and the vocabulary tables; None for a replicated leaf
    (norms, biases, gates, convolutions, routers, LoRA ``b``).  Works for
    a full name and for the part under a stack's prefix alike."""
    parts = name.split(".")
    if parts[-1] == "w" and len(parts) >= 2:
        if parts[-2] in _COLUMN:
            return -2
        if parts[-2] in _ROW:
            return -1
        return None
    if parts[-1] == "table":
        return -1
    if parts[-1] in ("in_bc", "in_dt"):
        return -2
    if parts[-1] in ("wq", "wk") and "slstm" not in parts:
        return -2
    if len(parts) >= 2 and parts[-2] == "experts":
        return -2
    if parts[-1] == "a" and "lora" in parts:
        return -2
    return None


_TP_COLUMN = frozenset(["wq", "wk", "wv", "gate", "up", "fc1"])
_TP_ROW = frozenset(["wo", "down", "fc2"])
#: the hybrid and ssm families' leaves under ``groups.`` that ``model``
#: shards along their last dim (the Mamba2 heads, head-major; the mLSTM
#: heads x v-parts; the LoRA ``b`` like its base weight's columns) and
#: along their second-to-last (the row linears); every other leaf there
#: is replicated over ``model``
_TP_GROUP_LAST = frozenset(
    ["mamba." + n for n in ("A_log", "D", "conv_x", "dt_bias", "in_dt",
                            "in_x.w", "in_z.w", "norm")]
    + ["mlstm." + n for n in ("norm", "up_v.w", "up_z.w")]
    + [f"lora.{n}.b" for n in ("gate", "up", "wq")])
_TP_GROUP_ROW = frozenset(["mamba.out.w", "mlstm.out.w"])


def tp_dim(name: str, kv_replicated: bool = False) -> "int | None":
    """The dim, counted from the end, along which ``model`` shards the
    leaf ``name``, a full name (the JAX package's ``PartitionSpec``).

    Under ``groups.`` (the hybrid and ssm families) the name after the
    prefix decides, never its last part alone: -1 for the Mamba2
    ``in_x.w``, ``in_z.w``, ``in_dt``, ``conv_x``, ``norm``, ``A_log``,
    ``D`` and ``dt_bias``, the mLSTM ``up_v.w``, ``up_z.w`` and ``norm``
    and the LoRA ``b``; -2 for the two ``out.w``; None for the rest (the
    Mamba2 ``in_bc``, ``conv_bc`` and ``ln``, the mLSTM q/k/gate weights,
    ``conv`` and ``ln``, every sLSTM leaf, whose ``ffn.up``/``ffn.down``
    and ``norm`` share last parts with sharded leaves, and the LoRA
    ``a``).

    Elsewhere (the dense, MoE, vlm and enc-dec leaves and the shared
    zamba2 block): -1 for column linears (``wq``, ``wk``, ``wv``,
    ``gate``, ``up``, ``fc1``; not ``wk``/``wv`` when the KV heads are
    replicated over ``model``), -2 for row linears (``wo``, ``down``,
    ``fc2``) and the vocabulary tables, -3 for the stacked MoE experts
    ``(.., E, d_in, d_out)``; None for a leaf replicated over ``model``
    (norms, the router, the shared-expert gate)."""
    if name.startswith("groups."):
        rest = name[len("groups."):]
        if rest in _TP_GROUP_LAST:
            return -1
        return -2 if rest in _TP_GROUP_ROW else None
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "experts":
        return -3
    if parts[-1] == "table":
        return -2
    if parts[-1] == "w" and len(parts) >= 2:
        if parts[-2] in ("wk", "wv") and kv_replicated:
            return None
        if parts[-2] in _TP_COLUMN:
            return -1
        if parts[-2] in _TP_ROW:
            return -2
    return None


def gather_params(p: dict, ctx: ShardCtx) -> dict:
    """``p`` (name -> tensor) with every leaf that FSDP shards
    (:func:`fsdp_dim`) cast to the compute dtype and gathered along its
    dim; the other leaves as they are.  Without FSDP axes, ``p``
    itself."""
    if not ctx.fsdp_axes:
        return p
    out = {}
    for k, v in p.items():
        dim = fsdp_dim(k)
        out[k] = v if dim is None \
            else fsdp_gather(v.to(ctx.compute_dtype), ctx, dim)
    return out


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


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """qwen2-vl's (16, 24, 24) / 64 split of the half-spectrum, scaled to
    ``head_dim`` (temporal / height / width)."""
    half = head_dim // 2
    hw = 3 * half // 8
    return (half - 2 * hw, hw, hw)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: "tuple[int, ...] | None" = None) -> torch.Tensor:
    """M-RoPE: x (B, S, H, hd); positions (3, B, S), the t, h and w ids,
    each rotating its own section of the frequencies (Qwen2-VL §3.1)."""
    half = x.shape[-1] // 2
    if sections is None:
        sections = mrope_sections(x.shape[-1])
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    # each frequency's section, built on the device from Python ints (no
    # host-to-device copy, so no host sync)
    ar = torch.arange(half, device=x.device)
    sec_id = torch.zeros(half, dtype=torch.int64, device=x.device)
    edge = 0
    for n in sections[:-1]:
        edge += n
        sec_id += ar >= edge
    pos = positions.index_select(0, sec_id)                  # (half, B, S)
    ang = pos.movedim(0, -1).float() * freqs                 # (B, S, half)
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


def sp_scatter_embeds(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """A whole-sequence ``(B, S, ...)`` input (precomputed embeddings,
    frames, positional encodings) -> this model rank's slice ``[m S/tp,
    (m + 1) S/tp)`` along dim 1 under SP at ``tp > 1``, ``x`` itself
    otherwise (JAX ``sp_scatter_embeds``).  A plain slice, with no
    collective: what it slices is an input, and no gradient leaves it."""
    if not (ctx.seq_parallel and ctx.tp > 1):
        return x
    n = x.shape[1] // ctx.tp
    return x.narrow(1, coll.tp_index() * n, n)


def pad_vocab(vocab: int, tp: int) -> int:
    return -(-vocab // tp) * tp


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, ctx: ShardCtx,
                     vocab: int) -> torch.Tensor:
    """ids: (B, S) -> (B, S, d) in the compute dtype (the table gathered
    along d under FSDP).  Vocabulary-parallel under TP: each rank looks up
    the ids of its rows of the table, zeros elsewhere, and the partial
    sums are summed over ``model`` (reduce-scattered over the sequence
    under SP, so the result is this rank's ``(B, S/tp, d)``)."""
    table = fsdp_gather(table.to(ctx.compute_dtype), ctx, 1)
    if ctx.tp == 1:
        return torch.nn.functional.embedding(ids.clamp(max=vocab - 1), table)
    shard = table.shape[0]
    local = ids - coll.tp_index() * shard
    ok = (local >= 0) & (local < shard)
    emb = torch.nn.functional.embedding(local.clamp(0, shard - 1), table)
    return tp_reduce(emb * ok[..., None].to(emb.dtype), ctx)


def unembed_logits(table: torch.Tensor, x: torch.Tensor,
                   ctx: ShardCtx) -> torch.Tensor:
    """x: (B, S, d) -> logits (B, S, V/tp), this rank's vocabulary rows
    (the table gathered along d under FSDP)."""
    return x @ fsdp_gather(table.to(ctx.compute_dtype), ctx, 1).T


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        ctx: ShardCtx = ShardCtx(),
                        vocab: "int | None" = None) -> torch.Tensor:
    """Per-token cross-entropy in fp32: logsumexp - gold logit.  Under TP
    ``logits`` are this rank's ``(B, S, V/tp)`` and ``labels`` global ids:
    the maximum (a stabilizer, without gradient), the sum of the
    exponentials and the gold logit are reduced over ``model`` by sums
    whose backward is the identity, so each rank's gradient is that of the
    one loss.  The columns past ``vocab`` (``pad_vocab``'s padding) are
    masked to ``-inf``, so the loss is that of the logical vocabulary at
    any ``tp`` (the JAX package counts them in its softmax)."""
    ll = logits.float()
    if ctx.tp == 1:
        lse = torch.logsumexp(ll, dim=-1)
        gold = torch.gather(ll, -1, labels[..., None])[..., 0]
        return lse - gold
    shard = ll.shape[-1]
    if vocab is not None and shard * ctx.tp > vocab:
        col = coll.tp_index() * shard + torch.arange(shard, device=ll.device)
        ll = ll.masked_fill(col >= vocab, float("-inf"))
    with torch.no_grad():
        m = coll.pmax(ll.amax(dim=-1), (coll.TP_AXIS,))
    sumexp = tp_reduce(torch.exp(ll - m[..., None]).sum(-1), ctx,
                       seq_parallel=False)
    lse = m + torch.log(sumexp)
    local = labels - coll.tp_index() * shard
    ok = (local >= 0) & (local < shard)
    gold_local = torch.gather(ll, -1, local.clamp(0, shard - 1)[..., None]
                              )[..., 0]
    gold = tp_reduce(gold_local * ok, ctx, seq_parallel=False)
    return lse - gold
