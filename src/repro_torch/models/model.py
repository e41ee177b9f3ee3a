"""The model as an ``nn.Module``: every family of
``repro.models.model.Model`` (dense, vlm, MoE, hybrid, ssm and audio;
init and loss; prefill and decode for the dense, vlm and MoE families).

The parameters are stored as the JAX package stores them: one stacked
leaf per block weight, weights laid out ``(d_in, d_out)``, under the JAX
tree's key paths joined by dots, and registered in the JAX tree's leaf
order (sorted keys at every level, uppercase first).  The dense family
stacks ``(n_layers, ...)`` blocks under ``blocks.``:

    blocks.attn.{k_norm,q_norm}.scale (qk-norm only),
    blocks.attn.{wk,wo,wq,wv}.w, blocks.ln1.scale, blocks.ln2.scale,
    blocks.mlp.{down,gate,up}.w, embed.table, final_norm.scale,
    unembed.table

The MoE block has ``blocks.moe`` in place of ``blocks.mlp``:
``dense.{down,gate,up}.w`` (the dense residual), ``experts.{down,gate,up}``
(``(L, E, d_ff, d)`` / ``(L, E, d, d_ff)``, with no ``.w``), ``router``
``(L, d, E)``, ``shared.{down,gate,up}.w`` and ``shared_gate`` ``(L, d,
1)``.

The hybrid family (zamba2) stacks ``G = n_layers // attn_every`` groups
under ``groups.``, which sort after ``embed`` and ``final_norm``:

    embed.table, final_norm.scale,
    groups.lora.{gate,up,wq}.{a,b}        (G, d, r) / (G, r, d_out)
    groups.mamba.{A_log, D, conv_bc, conv_x, dt_bias, in_bc, in_dt,
                  in_x.w, in_z.w, ln, norm, out.w}   (G, attn_every, ...)
    shared.attn.{wk,wo,wq,wv}.w, shared.ln1.scale, shared.ln2.scale,
    shared.mlp.{down,gate,up}.w           (one dense block, unstacked)
    unembed.table

A group runs the shared dense block with ``w + a @ b`` (rank
``ZAMBA_LORA_RANK``, fp32 product cast to ``w``'s dtype) in place of
``attn.wq``, ``mlp.gate`` and ``mlp.up``, then its ``attn_every`` Mamba2
blocks (``models.mamba2``).  ``lora.*.b`` starts at zero.  Under TP the
patch is made in shard space, ``w_local + a @ b_local``: ``b`` is
sharded like ``w``'s columns, and ``a``, replicated, is read under
``tp_shared``.

The ssm family (xLSTM) stacks ``G = n_layers // slstm_every`` groups
under ``groups.``, each ``slstm_every - 1`` mLSTM blocks then one sLSTM
block (``models.xlstm``), with no positional input (``rope="none"``):

    embed.table, final_norm.scale,
    groups.mlstm.{b_if, conv, ln, norm, out.w, up_v.w, up_z.w, w_if, wk,
                  wq}                     (G, slstm_every - 1, ...)
    groups.slstm.{b_gates, conv, ffn.down, ffn.up, ln, ln2, norm,
                  r_gates, w_gates}       (G, ...)
    unembed.table

``b_if`` starts at zeros then ``linspace(3, 6)``, ``b_gates`` at zeros with
3.0 on the forget gates.

The audio family (seamless) is an encoder of ``encdec.enc_layers``
blocks and a decoder of ``n_layers`` blocks (``models.encdec``), whose
cross-attention reads the encoder's normed output (the memory):

    dec_blocks.{cross.{wk,wo,wq,wv}.w, ln1, ln2, ln3, mlp.{fc1,fc2}.w,
                self.{wk,wo,wq,wv}.w}     (n_layers, ...)
    embed.table,
    enc_blocks.{attn.{wk,wo,wq,wv}.w, ln1, ln2, mlp.{fc1,fc2}.w}
                                          (enc_layers, ...)
    enc_norm.scale, final_norm.scale, unembed.table

(each norm a ``.scale``).  Its ``loss`` reads ``batch["enc_embeds"]``, the
stubbed speech frontend's ``(B, S_enc, d_model)`` frame embeddings; both
stacks' inputs take sinusoidal positions (``rope="none"``).

The vlm family (qwen2-vl) has the dense family's leaves and rotates by
M-RoPE (``rope="mrope"``): its ``loss`` reads ``batch["mrope_positions"]``
``(3, B, S)`` and raises ``KeyError`` without it.  Any family's ``loss``
takes ``batch["embeds"]`` ``(B, S, d_model)`` (the stubbed vision
frontend's patch and text embeddings), cast to the compute dtype, in
place of the token lookup when the batch has it.

FSDP (``ctx.fsdp_axes`` set): every leaf that ``layers.fsdp_dim`` names
is built at its local shard shape, that dim divided by the FSDP degree,
and gathered at use: a stage's leaves at the top of its (recomputed)
function, the vocabulary tables in the lookup and in each loss chunk.
``init_params`` draws each global leaf in leaf order (above
``DRAW_BLOCK`` elements in blocks of whole rows) and keeps this rank's
slice before it draws the next, so the global parameters are the same
at every FSDP degree and one block is the largest transient.

Tensor parallelism (``ctx.tp > 1``, every family): every leaf that
``layers.tp_dim`` names holds this rank's slice along that dim (composed
with the FSDP dim: a column weight is ``P(fsdp, model)``), at the global
shapes of the JAX package at that ``tp``: the vocabulary padded to a
multiple of ``tp`` (``pad_vocab``), the q heads (and the zamba2 LoRA
``wq.b`` columns with them) to the ``head_layout``'s ``n_h_pad``, the
experts to ``E_pad``.  The kv weights are replicated over ``model`` when
``kv_heads < tp``.  The Mamba2 blocks hold ``H / tp`` SSD heads, the
mLSTM blocks ``xlstm.vh_layout``'s heads x v-parts, and the sLSTM
blocks run replicated.  ``init_params`` draws each global leaf and
slices it, so a seed gives the same global weights at any ``tp`` where
nothing is padded, as the JAX package's init does.  ``loss`` takes the
rotary positions from the labels, which hold the whole sequence under SP
too.
Under SP a whole-sequence float input (the vlm ``embeds``, the audio
``enc_embeds`` and both stacks' sinusoidal positions, built over the
whole sequence) is sliced to this rank's part of the sequence
(``layers.sp_scatter_embeds``); the memory enters the decoder through
``tp_copy`` (gathered under SP), so every cross-attention reads it whole
and its gradient is summed over ``model`` once.

Whatever the parameter dtype, the MoE ``router`` and ``shared_gate``, the
Mamba2 ``A_log``, ``D`` and ``dt_bias``, and the xLSTM ``b_if``, ``w_if``,
``b_gates``, ``r_gates`` and ``w_gates`` are fp32 (``leaf_dtype``).

``parameters()`` therefore yields the leaves in the order in which the JAX
package ravels its gradient into buckets, which PowerSGD depends on.  The
block loop takes stage ``l``'s slice of each stacked leaf; ``remat="full"``
recomputes each stage (a block, or a group) in the backward pass, and
inside a group each block again, as the JAX package nests its remat.
``loss`` is three stages (``stage_embed``, ``stage_block`` per layer or
group, ``stage_loss``), which the overlapped step
(``repro_torch.train.overlap``) runs one autograd graph at a time; the
audio family's encoder adds ``stage_encoder_in``, a ``stage_block`` per
encoder block and ``stage_memory`` before them.  ``stacks`` lists the
stacked collections in backward-completion order: one for every family
but audio, whose decoder's gradients are final before its encoder's.

Serving (the dense, vlm and MoE families, ``SERVE_FAMILIES``; JAX
``Model.prefill``, ``decode`` and ``cache_shape``): ``prefill`` runs the
blocks once over the prompt and ``decode`` over one token at ``cur_len``,
both under ``torch.inference_mode()``, each block writing its layer's
slice of the cache ``{"k", "v"}`` ``(n_layers, B, Sc, kv_local, hd)``
(``new_cache``, bf16 as the JAX package's, allocated once) in place;
each returns the last position's vocabulary-parallel logits and the
cache.  The hybrid, ssm and audio families raise
``NotImplementedError`` (``check_serving``).  Under the 2-D MoE serving
layout (``ctx.moe_ep_axis``) each expert leaf holds its slice of the
experts along ``ep_dims`` and, at ``tp > 1``, of ``d_ff`` (``tp_dims``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import encdec, mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm
from repro_torch.models.layers import (ShardCtx, embedding_lookup, fsdp_dim,
                                       gather_params, head_layout,
                                       maybe_tp_shared, pad_vocab,
                                       rmsnorm, sinusoidal_positions,
                                       sp_scatter_embeds, sp_shared, tp_copy,
                                       tp_dim, trunc_normal_)
from repro_torch.parallel import collectives as coll

BLOCK_PREFIX = "blocks."
SHARED_PREFIX = "shared."
DEC_PREFIX, ENC_PREFIX = "dec_blocks.", "enc_blocks."
#: the single-stack families, and the prefix of each one's stacked
#: leaves (the JAX package's ``params`` key)
STACK_PREFIX = {"dense": BLOCK_PREFIX, "vlm": BLOCK_PREFIX,
                "moe": BLOCK_PREFIX, "hybrid": "groups.", "ssm": "groups."}
#: the families the port builds (at any ``tp``)
FAMILIES = (*STACK_PREFIX, "audio")
#: each family's rotary scheme (``ArchConfig.rope``): the ssm family has
#: no positional input, the audio family adds sinusoidal positions under
#: "none", the vlm family rotates by M-RoPE
ROPE = {"ssm": "none", "audio": "none", "vlm": "mrope"}
#: the rank of the zamba2 shared block's per-group LoRA adapters
ZAMBA_LORA_RANK = 64
#: shared-block weight -> the LoRA adapter patched into it in every group
LORA_TARGETS = {"attn.wq.w": "wq", "mlp.gate.w": "gate", "mlp.up.w": "up"}
#: the prefix of the MoE family's stacked expert leaves
EXPERTS = "blocks.moe.experts."
#: the families that serve (prefill and decode with a KV cache)
SERVE_FAMILIES = ("dense", "vlm", "moe")
#: ``init_params`` draws a leaf of more elements than this in blocks of
#: whole rows, so that no full-size leaf is ever whole in fp32 on a rank
DRAW_BLOCK = 1 << 26
#: the leaves kept in fp32 whatever the parameter dtype
FP32_LEAVES = frozenset(
    [BLOCK_PREFIX + n for n in moe_mod.FP32_LEAVES]
    + ["groups.mamba." + n for n in mamba2.FP32_LEAVES]
    + ["groups.mlstm." + n for n in xlstm.MLSTM_FP32_LEAVES]
    + ["groups.slstm." + n for n in xlstm.SLSTM_FP32_LEAVES])


def _mlp_layout(prefix: str, lead: tuple, d: int, d_ff: int) -> list:
    return [(prefix + "down.w", (*lead, d_ff, d), 1 / math.sqrt(d_ff)),
            (prefix + "gate.w", (*lead, d, d_ff), 1 / math.sqrt(d)),
            (prefix + "up.w", (*lead, d, d_ff), 1 / math.sqrt(d))]


def _moe_layout(cfg, tp: int = 1) -> list:
    L, d, f = (cfg.n_layers,), cfg.d_model, cfg.d_ff
    mc = cfg.moe
    e = moe_mod.pad_experts(mc.n_experts, tp)
    out = _mlp_layout("blocks.moe.dense.", L, d, f) \
        if mc.dense_residual else []
    out += [("blocks.moe.experts.down", (*L, e, f, d), 1 / math.sqrt(f)),
            ("blocks.moe.experts.gate", (*L, e, d, f), 1 / math.sqrt(d)),
            ("blocks.moe.experts.up", (*L, e, d, f), 1 / math.sqrt(d)),
            ("blocks.moe.router", (*L, d, e), 0.02)]
    if mc.n_shared:
        out += _mlp_layout("blocks.moe.shared.", L, d, f * mc.n_shared)
        out.append(("blocks.moe.shared_gate", (*L, d, 1), 0.02))
    return out


def _attn_layout(cfg, prefix: str, lead: tuple, tp: int = 1) -> list:
    """The pre-norm attention half of a dense block, and its two norms
    (the q heads padded as ``head_layout`` pads them at ``tp``)."""
    d, hd = cfg.d_model, cfg.head_dim
    n_q = head_layout(cfg.n_heads, cfg.n_kv_heads, hd, tp).n_h_pad \
        if tp > 1 else cfg.n_heads
    q_out, kv_out = n_q * hd, cfg.n_kv_heads * hd
    out = []
    if cfg.qk_norm:
        out += [(prefix + "attn.k_norm.scale", (*lead, hd), None),
                (prefix + "attn.q_norm.scale", (*lead, hd), None)]
    return out + [
        (prefix + "attn.wk.w", (*lead, d, kv_out), 1 / math.sqrt(d)),
        (prefix + "attn.wo.w", (*lead, q_out, d),
         1 / math.sqrt(cfg.n_heads * hd)),
        (prefix + "attn.wq.w", (*lead, d, q_out), 1 / math.sqrt(d)),
        (prefix + "attn.wv.w", (*lead, d, kv_out), 1 / math.sqrt(d)),
        (prefix + "ln1.scale", (*lead, d), None),
        (prefix + "ln2.scale", (*lead, d), None)]


def _hybrid_layout(cfg, tp: int = 1) -> list:
    """The zamba2 groups and the shared block, in leaf order (the q heads
    and the LoRA ``wq.b`` columns padded as ``head_layout`` pads them at
    ``tp``)."""
    d = cfg.d_model
    g = (cfg.n_layers // cfg.ssm.attn_every,)
    n_q = head_layout(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, tp).n_h_pad \
        if tp > 1 else cfg.n_heads
    d_out = {"gate": cfg.d_ff, "up": cfg.d_ff, "wq": n_q * cfg.head_dim}
    out = []
    for name in sorted(d_out):
        out += [(f"groups.lora.{name}.a", (*g, d, ZAMBA_LORA_RANK),
                 1 / math.sqrt(d)),
                (f"groups.lora.{name}.b", (*g, ZAMBA_LORA_RANK, d_out[name]),
                 "zeros")]
    out += mamba2.param_layout(cfg, (*g, cfg.ssm.attn_every),
                               "groups.mamba.")
    out += _attn_layout(cfg, SHARED_PREFIX, (), tp)
    return out + _mlp_layout(SHARED_PREFIX + "mlp.", (), d, cfg.d_ff)


def _xlstm_layout(cfg) -> list:
    """The xLSTM groups: per group ``slstm_every - 1`` mLSTM blocks and
    one sLSTM block, in leaf order."""
    g = cfg.n_layers // cfg.ssm.slstm_every
    return xlstm.mlstm_layout(cfg, (g, cfg.ssm.slstm_every - 1),
                              "groups.mlstm.") \
        + xlstm.slstm_layout(cfg, (g,), "groups.slstm.")


def param_layout(cfg, tp: int = 1) -> list[tuple[str, tuple[int, ...],
                                                  "float | str | None"]]:
    """(name, shape, init) of every leaf, in leaf order, at its global
    shape for tensor-parallel degree ``tp`` (padded as the JAX package
    pads).  ``init`` is a truncated-normal std, None for ones,
    ``"zeros"``, or the name of a Mamba2 or xLSTM draw
    (``mamba2.param_layout``, ``xlstm.mlstm_layout``,
    ``xlstm.slstm_layout``)."""
    d = cfg.d_model
    v = pad_vocab(cfg.vocab, tp)
    io = [("embed.table", (v, d), 0.02),
          ("final_norm.scale", (d,), None)]
    tail = [] if cfg.tie_embeddings \
        else [("unembed.table", (v, d), 0.02)]
    if cfg.family == "hybrid":
        return io + _hybrid_layout(cfg, tp) + tail
    if cfg.family == "ssm":
        return io + _xlstm_layout(cfg) + tail
    if cfg.family == "audio":
        return encdec.dec_layout(cfg, (cfg.n_layers,), DEC_PREFIX, tp) \
            + io[:1] + encdec.enc_layout(cfg, (cfg.encdec.enc_layers,),
                                         ENC_PREFIX, tp) \
            + [("enc_norm.scale", (d,), None)] + io[1:] + tail
    out = _attn_layout(cfg, BLOCK_PREFIX, (cfg.n_layers,), tp)
    if cfg.family == "moe":
        out += _moe_layout(cfg, tp)
    else:
        out += _mlp_layout("blocks.mlp.", (cfg.n_layers,), d, cfg.d_ff)
    return out + io + tail


def param_dims(cfg) -> dict[str, "int | None"]:
    """name -> the dim of the leaf (counted from its first, stacking dims
    included) that FSDP shards, or None: the dims of the JAX package's
    ``Model.abstract_init`` specs with ``fsdp_axes`` set."""
    out = {}
    for name, shape, _ in param_layout(cfg):
        dim = fsdp_dim(name)
        out[name] = None if dim is None else dim % len(shape)
    return out


def tp_dims(cfg, tp: int, two_d: bool = False) -> dict[str, "int | None"]:
    """name -> the dim of the leaf (counted from its first) that ``model``
    shards at ``tp``, or None (every leaf at ``tp == 1``): the dims of
    the JAX package's ``abstract_init`` specs that name ``model``.  The
    ssm family has no attention, so its heads take no ``head_layout``.
    ``two_d``: the 2-D MoE serving layout, whose experts ``model`` shards
    along ``d_ff`` (the last dim of ``gate`` and ``up``, the
    second-to-last of ``down``)."""
    kv_rep = tp > 1 and cfg.family != "ssm" and head_layout(
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, tp).kv_replicated
    out = {}
    for name, shape, _ in param_layout(cfg, tp):
        dim = tp_dim(name, kv_rep) if tp > 1 else None
        if dim is not None and two_d and name.startswith(EXPERTS):
            dim = -2 if name.endswith("down") else -1
        out[name] = None if dim is None else dim % len(shape)
    return out


def ep_dims(cfg, tp: int) -> dict[str, int]:
    """name -> the expert dim of each stacked expert leaf: the dim that
    ``ShardCtx.moe_ep_axis`` shards in the 2-D serving layout."""
    return {name: len(shape) - 3 for name, shape, _ in param_layout(cfg, tp)
            if name.startswith(EXPERTS)}


def local_shape(name: str, shape: tuple, p: int, tp: int = 1,
                tdim: "int | None" = None, ep: int = 1,
                edim: "int | None" = None) -> tuple:
    """The shape of this rank's shard of ``name`` at FSDP degree ``p``,
    at TP degree ``tp`` along ``tdim`` (``tp_dims``), and at the 2-D MoE
    layout's expert-parallel degree ``ep`` along ``edim``."""
    out = list(shape)
    for dim, n, what in ((fsdp_dim(name), p, "FSDP"), (tdim, tp, "TP"),
                         (edim, ep, "EP")):
        if dim is None or n == 1:
            continue
        if out[dim] % n:
            raise ValueError(f"{name}: dim {dim % len(shape)} of "
                             f"{tuple(shape)} does not split over {n} "
                             f"{what} ranks")
        out[dim] //= n
    return tuple(out)


def leaf_dtype(name: str, ctx: ShardCtx) -> torch.dtype:
    """A leaf's storage dtype: fp32 for ``FP32_LEAVES`` (the MoE router
    and shared-expert gate, the Mamba2 ``A_log``, ``D`` and ``dt_bias``,
    the xLSTM gate weights and biases), ``ctx.param_dtype`` otherwise."""
    return torch.float32 if name in FP32_LEAVES else ctx.param_dtype


def init_leaf_(p: torch.Tensor, init: "float | str | None",
               generator: torch.Generator) -> None:
    """Fill one leaf as ``param_layout``'s ``init`` says."""
    if init is None:
        p.fill_(1.0)
    elif init == "zeros":
        p.zero_()
    elif init == "a_log":
        p.copy_(mamba2.a_log_init(p.shape[-1]).expand(p.shape))
    elif init == "dt_bias":
        mamba2.dt_bias_init_(p, generator)
    elif init == "b_if":
        p.copy_(xlstm.b_if_init(p.shape[-1] // 2).expand(p.shape))
    elif init == "b_gates":
        p.copy_(xlstm.b_gates_init(p.shape[-1] // 4).expand(p.shape))
    else:
        trunc_normal_(p, init, generator)


def _lora_patch(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                ctx: ShardCtx) -> torch.Tensor:
    """``w + a @ b``, the product in fp32 and cast to ``w``'s dtype.
    Under TP ``w`` and ``b`` are this rank's columns and ``a`` is read
    under ``tp_shared``: its gradient here covers only those columns
    (JAX ``_lora_patch``)."""
    a = maybe_tp_shared(a, ctx)
    return w + (a.float() @ b.float()).to(w.dtype)


def check_serving(cfg) -> None:
    """``NotImplementedError`` unless the port serves ``cfg``'s family."""
    if cfg.family not in SERVE_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: serving the {cfg.family!r} family is not ported "
            f"yet (the next serving slice ports the hybrid, ssm and audio "
            f"caches; the port serves {', '.join(SERVE_FAMILIES)})")


def _check_2d(cfg, ctx: ShardCtx, ep: int) -> None:
    """``ValueError`` unless the 2-D MoE layout applies: an MoE arch, no
    FSDP axes (the layout shards no expert over them, as in the JAX
    package), and the experts padded to the same count at ``tp`` and at
    the expert-parallel degree ``ep``."""
    if cfg.family != "moe":
        raise ValueError(f"{cfg.name}: moe_ep_axis on the "
                         f"{cfg.family!r} family")
    if ctx.fsdp_axes:
        raise ValueError("the 2-D MoE layout with FSDP axes")
    n = cfg.moe.n_experts
    if moe_mod.pad_experts(n, ctx.tp) != moe_mod.pad_experts(n, ep):
        raise ValueError(f"{n} experts pad to {moe_mod.pad_experts(n, ep)} "
                         f"over {ep} {ctx.moe_ep_axis} ranks but to "
                         f"{moe_mod.pad_experts(n, ctx.tp)} at tp={ctx.tp}")


def _check_recurrent_heads(cfg, tp: int) -> None:
    """``ValueError`` unless the recurrent blocks split over ``model`` at
    ``tp``: whole Mamba2 heads on every rank, or an mLSTM layout of
    ``xlstm.vh_layout``."""
    if cfg.family == "hybrid":
        heads = mamba2.dims(cfg)[1]
        if heads % tp:
            raise ValueError(f"{cfg.name}: {heads} SSD heads do not split "
                             f"over tp={tp}")
    elif cfg.family == "ssm":
        _, hn, _, dv = xlstm.mlstm_dims(cfg)
        xlstm.vh_layout(hn, dv, tp)


class Model(nn.Module):
    def __init__(self, cfg, ctx: ShardCtx = ShardCtx(),
                 device: "str | torch.device | None" = None,
                 fsdp_size: "int | None" = None):
        """Parameters of ``leaf_dtype``, uninitialised, on ``device``:
        ``cuda`` unless the caller asks for ``cpu`` or ``meta``.  Under
        ``ctx.fsdp_axes`` each sharded leaf has its local shape at the
        axes' size (``fsdp_size``, else read from the process group); at
        ``ctx.tp > 1`` each leaf ``model`` shards has its slice's; under
        ``ctx.moe_ep_axis`` each expert leaf holds its slice of the
        experts at that axis's size, read from the process group."""
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported "
                f"(the port has {', '.join(FAMILIES)})")
        if ctx.tp > 1:
            _check_recurrent_heads(cfg, ctx.tp)
        if cfg.rope != ROPE.get(cfg.family, "rope"):
            raise NotImplementedError(f"{cfg.name}: rope={cfg.rope!r} in "
                                      f"the {cfg.family!r} family")
        if cfg.plan.remat not in ("none", "full"):
            raise NotImplementedError(f"remat={cfg.plan.remat!r}")
        if torch.device(device or "cuda").type != "meta":
            device = mesh_mod.resolve_device(device)
        self.cfg = cfg
        self.ctx = ctx
        if fsdp_size is None:
            fsdp_size = mesh_mod.size(ctx.fsdp_axes) if ctx.fsdp_axes else 1
        #: the FSDP degree the leaves are sharded at (1: global shapes)
        self.fsdp_size = fsdp_size
        #: name -> the dim ``model`` shards (None: replicated over it)
        self.tp_dims = tp_dims(cfg, ctx.tp, two_d=bool(ctx.moe_ep_axis))
        #: name -> the expert dim ``ctx.moe_ep_axis`` shards (the 2-D
        #: MoE serving layout; empty otherwise)
        self.ep_dims = ep_dims(cfg, ctx.tp) if ctx.moe_ep_axis else {}
        #: the expert-parallel degree of the 2-D layout (1 without it)
        self.ep_size = mesh_mod.size((ctx.moe_ep_axis,)) \
            if ctx.moe_ep_axis else 1
        if ctx.moe_ep_axis:
            _check_2d(cfg, ctx, self.ep_size)
        self._init = {}
        self._global = {}
        for name, shape, init in param_layout(cfg, ctx.tp):
            *path, leaf = name.split(".")
            node: nn.Module = self
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, nn.Module())
                node = getattr(node, part)
            node.register_parameter(leaf, nn.Parameter(torch.empty(
                local_shape(name, shape, fsdp_size, ctx.tp,
                            self.tp_dims[name], self.ep_size,
                            self.ep_dims.get(name)),
                dtype=leaf_dtype(name, ctx), device=device)))
            self._init[name] = init
            self._global[name] = tuple(shape)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        """The leaves in leaf order.  ``nn.Module`` would yield a module's
        own parameters before its children's, which puts
        ``blocks.moe.router`` ahead of ``blocks.moe.experts.*``."""
        if not recurse:
            yield from super().named_parameters(prefix, recurse,
                                                remove_duplicate)
            return
        params = dict(super().named_parameters())
        for name in self._init:
            yield prefix + ("." if prefix else "") + name, params[name]

    def global_shape(self, name: str) -> tuple:
        """The leaf's shape before FSDP and TP sharding."""
        return self._global[name]

    def slice_spans(self, name: str) -> list[tuple[int, int]]:
        """Per dim of the global leaf ``name``, (start, length) of this
        rank's slice: along its FSDP dim at its index along the FSDP
        axes, along its TP dim at its ``model`` index, along its expert
        dim at its index along ``ctx.moe_ep_axis`` (the 2-D layout)."""
        spans = [(0, n) for n in self._global[name]]
        fdim = fsdp_dim(name)
        cuts = (
            (None if fdim is None else fdim % len(spans), self.fsdp_size,
             lambda: mesh_mod.rank(self.ctx.fsdp_axes)),
            (self.tp_dims[name], self.ctx.tp, coll.tp_index),
            (self.ep_dims.get(name), self.ep_size,
             lambda: mesh_mod.rank((self.ctx.moe_ep_axis,))))
        for dim, deg, index in cuts:
            if dim is not None and deg > 1:
                start, n = spans[dim]
                spans[dim] = (start + index() * (n // deg), n // deg)
        return spans

    def shard_slice(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global leaf ``full`` (``full`` itself
        when the leaf is not sharded; ``slice_spans``)."""
        for dim, (start, n) in enumerate(self.slice_spans(name)):
            if n != full.shape[dim]:
                full = full.narrow(dim, start, n)
        return full

    def init_params(self, generator: torch.Generator) -> None:
        """Every leaf as ``param_layout`` says (truncated-normal weights,
        unit norm scales, zero LoRA ``b``, the Mamba2 ``A_log``, ``D`` and
        ``dt_bias``), drawn in leaf order from ``generator``: a global
        leaf of at most ``DRAW_BLOCK`` elements whole, a larger one in
        blocks of whole rows along its leading dims, in row-major order
        (each block one call of the leaf's init).  A sharded rank keeps
        its slice of each, so one seed gives the same global parameters
        on any mesh."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                self._init_leaf(name, p, generator)

    def _init_leaf(self, name: str, p: torch.Tensor,
                   generator: torch.Generator) -> None:
        shape, init = self._global[name], self._init[name]
        k = next(i for i in range(len(shape) + 1)
                 if math.prod(shape[i:]) <= DRAW_BLOCK)
        if k == 0:
            if tuple(p.shape) == shape:
                init_leaf_(p, init, generator)
            else:
                full = torch.empty(shape, dtype=p.dtype, device=p.device)
                init_leaf_(full, init, generator)
                p.copy_(self.shard_slice(name, full))
            return
        lead, row = shape[:k], shape[k:]
        n, per = math.prod(lead), max(1, DRAW_BLOCK // math.prod(row))
        spans = self.slice_spans(name)
        rows = p.view(-1, *p.shape[k:])           # this rank's rows
        for r0 in range(0, n, per):
            block = torch.empty((min(per, n - r0), *row), dtype=p.dtype,
                                device=p.device)
            init_leaf_(block, init, generator)
            # each block row's index along the leading dims, whether this
            # rank keeps it, and where among this rank's rows
            rest = torch.arange(r0, r0 + block.shape[0])
            keep = torch.ones(block.shape[0], dtype=torch.bool)
            local, stride = torch.zeros_like(rest), 1
            for size, (st, ln) in zip(reversed(lead), reversed(spans[:k])):
                i, rest = rest % size, rest // size
                keep &= (i >= st) & (i < st + ln)
                local += (i - st) * stride
                stride *= ln
            if not keep.any():
                continue
            for d, (st, ln) in enumerate(spans[k:]):
                block = block.narrow(d + 1, st, ln)
            rows.index_copy_(0, local[keep].to(p.device),
                             block[keep.to(p.device)])

    # ---- the three stages of the loss; the classic step runs them in one
    # ---- autograd graph, the overlapped step one graph per stage ----------
    def stage_embed(self, table: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
        """tokens (B, S) -> the first block's input (B, S, d), this rank's
        (B, S/tp, d) under SP; the audio family's decoder adds its
        sinusoidal positions."""
        x = embedding_lookup(table, tokens, self.ctx, self.cfg.vocab)
        if self.cfg.family == "audio":
            x = self._add_positions(x, tokens.shape[1])
        return x

    def stage_embeds(self, embeds: torch.Tensor) -> torch.Tensor:
        """Precomputed embeddings (B, S, d) (the vlm family's stubbed
        frontend) -> the first block's input, in the compute dtype (this
        rank's slice of the sequence under SP)."""
        return sp_scatter_embeds(embeds.to(self.ctx.compute_dtype), self.ctx)

    def mrope_positions(self, batch: dict) -> "torch.Tensor | None":
        """The batch's ``(3, B, S)`` M-RoPE positions under
        ``rope="mrope"`` (``KeyError`` without them, where the JAX
        package fails in ``apply_mrope``), else None."""
        return batch["mrope_positions"] if self.cfg.rope == "mrope" \
            else None

    def _add_positions(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """``x`` (this rank's slice of a sequence of ``s`` under SP) plus
        the sinusoids of its global positions, built over the whole
        sequence, sliced as ``x`` is and cast to ``x``'s dtype first, as
        the JAX package rounds them."""
        pe = sinusoidal_positions(torch.arange(s, device=x.device),
                                  self.cfg.d_model)
        pe = sp_scatter_embeds(pe.expand(x.shape[0], *pe.shape), self.ctx)
        return x + pe.to(x.dtype)

    def stage_encoder_in(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The audio family's frame embeddings (B, S_enc, d) -> the first
        encoder block's input: cast to the compute dtype (this rank's
        slice of the frames under SP), plus the sinusoidal positions."""
        x = sp_scatter_embeds(enc_embeds.to(self.ctx.compute_dtype), self.ctx)
        return self._add_positions(x, enc_embeds.shape[1])

    def stage_memory(self, enc_norm: torch.Tensor, x: torch.Tensor
                     ) -> torch.Tensor:
        """The last encoder block's output -> the memory every decoder
        block's cross-attention reads: ``enc_norm`` (its scale under
        ``sp_shared``), then ``tp_copy``, which gathers the frames under
        SP and whose backward sums the memory's gradient over ``model``
        (JAX ``Model._encode``)."""
        return tp_copy(rmsnorm(sp_shared(enc_norm, self.ctx), x,
                               self.cfg.norm_eps), self.ctx)

    @property
    def has_aux(self) -> bool:
        """Does ``stage_block`` return a load-balancing loss too?"""
        return self.cfg.family == "moe"

    @property
    def stack_prefix(self) -> str:
        """The prefix of the stacked leaves: ``blocks.`` or ``groups.``."""
        return STACK_PREFIX[self.cfg.family]

    @property
    def stacks(self) -> tuple[tuple[str, int], ...]:
        """(prefix, stages) of each stacked collection, in the order in
        which the backward completes them: the decoder's then the
        encoder's for the audio family, the one stack otherwise."""
        if self.cfg.family == "audio":
            return ((DEC_PREFIX, self.cfg.n_layers),
                    (ENC_PREFIX, self.cfg.encdec.enc_layers))
        return ((self.stack_prefix, self.n_stages),)

    @property
    def n_stages(self) -> int:
        """Slices of the stacked leaves: layers, or zamba2 or xLSTM
        groups."""
        if self.cfg.family == "hybrid":
            return self.cfg.n_layers // self.cfg.ssm.attn_every
        if self.cfg.family == "ssm":
            return self.cfg.n_layers // self.cfg.ssm.slstm_every
        return self.cfg.n_layers

    def _remat(self) -> bool:
        return self.cfg.plan.remat == "full" and torch.is_grad_enabled()

    def _group_apply(self, p_g: dict, shared: dict, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        """One zamba2 group: the shared block with this group's LoRA
        patched in, then its Mamba2 blocks, each recomputed in the
        backward pass under ``remat="full"``."""
        cfg, ctx = self.cfg, self.ctx
        patched = dict(shared)
        for w, name in LORA_TARGETS.items():
            patched[w] = _lora_patch(shared[w], p_g[f"lora.{name}.a"],
                                     p_g[f"lora.{name}.b"], ctx)
        remat = self._remat()
        dense = self._gathered(tf.dense_block_apply)
        args = (patched, x, positions, cfg, ctx)
        x = checkpoint(dense, *args, use_reentrant=False) \
            if remat else dense(*args)
        inner = [(name[len("mamba."):], p.unbind(0))
                 for name, p in p_g.items() if name.startswith("mamba.")]
        block = self._gathered(mamba2.mamba_block_apply)
        for i in range(cfg.ssm.attn_every):
            args = ({name: p[i] for name, p in inner}, x, cfg, ctx)
            x = checkpoint(block, *args, use_reentrant=False) if remat \
                else block(*args)
        return x

    def _gathered(self, fn):
        """``fn(p, *args)`` with ``p``'s sharded leaves gathered first
        (``layers.gather_params``): inside a recomputed stage the gather
        runs again, and its backward once per use.  ``fn`` itself without
        FSDP axes."""
        if not self.ctx.fsdp_axes:
            return fn
        ctx = self.ctx

        def run(p, *args, **kw):
            return fn(gather_params(p, ctx), *args, **kw)
        return run

    def _xlstm_group_apply(self, p_g: dict, x: torch.Tensor) -> torch.Tensor:
        """One xLSTM group: its mLSTM blocks, then its sLSTM block, each
        recomputed in the backward pass under ``remat="full"``."""
        cfg, ctx = self.cfg, self.ctx
        remat = self._remat()
        inner = [(name[len("mlstm."):], p.unbind(0))
                 for name, p in p_g.items() if name.startswith("mlstm.")]
        blocks = [(xlstm.mlstm_block_apply, {name: p[i] for name, p in inner})
                  for i in range(cfg.ssm.slstm_every - 1)]
        blocks.append((xlstm.slstm_block_apply,
                       {name[len("slstm."):]: p for name, p in p_g.items()
                        if name.startswith("slstm.")}))
        for fn, p in blocks:
            fn = self._gathered(fn)
            x = checkpoint(fn, p, x, cfg, ctx, use_reentrant=False) \
                if remat else fn(p, x, cfg, ctx)
        return x

    def stage_block(self, p_l: dict, x: torch.Tensor,
                    positions: torch.Tensor, shared: "dict | None" = None,
                    memory: "torch.Tensor | None" = None,
                    mrope_positions: "torch.Tensor | None" = None):
        """One stage on one slice of the stacked parameters (``p_l``:
        names under the stack's prefix -> that slice): a block, or for the
        hybrid family a group, which also reads ``shared`` (names under
        ``shared.`` -> the shared block's parameters), or for the ssm
        family an xLSTM group; for the audio family an encoder block, or
        with ``memory`` (B, S_enc, d) a decoder block.  Recomputed in the
        backward pass when ``remat="full"``, with ``memory`` an input of
        the recomputation, so its gradient flows.  Returns the stage's
        output, and for the MoE family (``has_aux``) ``(output,
        load-balancing loss)``.  The vlm family's block reads
        ``mrope_positions`` (3, B, S).  Under FSDP the stage's sharded
        leaves are gathered inside the recomputed function (the hybrid
        and ssm groups gather per inner block, after the LoRA patch of
        the shared block's shards)."""
        if self.cfg.family == "hybrid":
            fn, args = self._group_apply, (p_l, shared, x, positions)
        elif self.cfg.family == "ssm":
            fn, args = self._xlstm_group_apply, (p_l, x)
        elif memory is not None:
            fn = self._gathered(encdec.dec_block_apply)
            args = (p_l, x, memory, positions, self.cfg, self.ctx)
        elif self.cfg.family == "audio":
            fn = self._gathered(encdec.enc_block_apply)
            args = (p_l, x, positions, self.cfg, self.ctx)
        elif self.has_aux:
            fn = self._gathered(moe_mod.moe_block_apply)
            args = (p_l, x, positions, self.cfg, self.ctx)
        else:
            fn = self._gathered(tf.dense_block_apply)
            args = (p_l, x, positions, self.cfg, self.ctx, mrope_positions)
        if self._remat():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def stage_loss(self, final_scale: torch.Tensor, table: torch.Tensor,
                   x: torch.Tensor, labels: torch.Tensor,
                   xent_chunk: int = 1024
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The last block's output -> (local loss sum, local token count):
        final norm, unembedding and the chunked cross-entropy."""
        return tf.lm_loss(final_scale, table, x, labels, self.cfg, self.ctx,
                          xent_chunk)

    def block_params(self, prefix: "str | None" = None
                     ) -> list[tuple[str, torch.Tensor]]:
        """(name under ``prefix``, stacked ``(stages, ...)`` parameter) in
        leaf order, of the stack under ``prefix`` (``stack_prefix`` unless
        given)."""
        pre = prefix or self.stack_prefix
        return [(name[len(pre):], p) for name, p in self.named_parameters()
                if name.startswith(pre)]

    def _slices(self, prefix: str) -> list[dict]:
        """Per stage, names under ``prefix`` -> that stage's slice."""
        stacked = [(name, p.unbind(0))
                   for name, p in self.block_params(prefix)]
        return [{name: slices[i] for name, slices in stacked}
                for i in range(len(stacked[0][1]))]

    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The audio family's encoder: frame embeddings (B, S_enc, d) ->
        the memory (B, S_enc, d)."""
        x = self.stage_encoder_in(enc_embeds)
        positions = positions_of(enc_embeds[..., 0])
        for p_l in self._slices(ENC_PREFIX):
            x = self.stage_block(p_l, x, positions)
        return self.stage_memory(self.enc_norm.scale, x)

    def shared_params(self) -> dict[str, torch.Tensor]:
        """name under ``shared.`` -> the hybrid family's shared block
        parameter (empty for the other families)."""
        return {name[len(SHARED_PREFIX):]: p
                for name, p in self.named_parameters()
                if name.startswith(SHARED_PREFIX)}

    def stage_input(self, batch: dict) -> torch.Tensor:
        """The first block's input: ``batch["embeds"]`` cast to the
        compute dtype when the batch has them, else the token lookup."""
        if "embeds" in batch:
            return self.stage_embeds(batch["embeds"])
        return self.stage_embed(self.embed.table, batch["tokens"])

    def loss(self, batch: dict, xent_chunk: int = 1024
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """batch: ``tokens`` (or ``embeds`` (B, S, d)) and ``labels`` (B,
        S) on the model's device, for the audio family ``enc_embeds`` (B,
        S_enc, d), for the vlm family ``mrope_positions`` (3, B, S).
        Returns (local loss sum, local token count, the load-balancing
        loss averaged over the layers: 0 but for the MoE family)."""
        labels = batch["labels"]
        mrope = self.mrope_positions(batch)
        memory = self.encode(batch["enc_embeds"]) \
            if self.cfg.family == "audio" else None
        x = self.stage_input(batch)
        positions = positions_of(labels)
        shared = self.shared_params()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p_l in self._slices(self.stacks[0][0]):
            x = self.stage_block(p_l, x, positions, shared, memory, mrope)
            if self.has_aux:
                x, a = x
                aux = aux + a
        table = self.embed.table if self.cfg.tie_embeddings \
            else self.unembed.table
        loss_sum, ntok = self.stage_loss(self.final_norm.scale, table, x,
                                         labels, xent_chunk)
        return loss_sum, ntok, aux / self.cfg.n_layers

    # ---- serving: prefill and one-token decode with a KV cache ----------
    def _serving(self) -> None:
        check_serving(self.cfg)

    def cache_shape(self, batch_local: int, cache_len_local: int
                    ) -> dict[str, tuple[int, ...]]:
        """The decode cache on this rank: ``{"k", "v"}``, each
        ``(n_layers, B_local, Sc_local, kv_local, hd)`` (the caller divides
        the capacity by the context-parallel degree)."""
        self._serving()
        shape = (self.cfg.n_layers, *tf.attn_cache_shape(
            self.cfg, self.ctx, batch_local, cache_len_local))
        return {"k": shape, "v": shape}

    def new_cache(self, batch_local: int, cache_len_local: int,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> dict[str, torch.Tensor]:
        """A zeroed cache of ``cache_shape`` in ``dtype`` (bf16, as the
        JAX package's) on the model's device, allocated once: prefill and
        decode write into it in place."""
        dev = self.embed.table.device
        return {k: torch.zeros(shape, dtype=dtype, device=dev)
                for k, shape in self.cache_shape(batch_local,
                                                 cache_len_local).items()}

    def _serve_blocks(self, x: torch.Tensor, positions: torch.Tensor,
                      mrope: "torch.Tensor | None", st: tf.StepState,
                      cache: dict) -> torch.Tensor:
        """Every block in order, each writing its layer's slice of
        ``cache`` in place."""
        fn = self._gathered(moe_mod.moe_block_apply if self.has_aux
                            else tf.dense_block_apply)
        for i, p_l in enumerate(self._slices(BLOCK_PREFIX)):
            layer = {k: c[i] for k, c in cache.items()}
            if self.has_aux:
                x, _ = fn(p_l, x, positions, self.cfg, self.ctx, step=st,
                          cache=layer)
            else:
                x = fn(p_l, x, positions, self.cfg, self.ctx, mrope,
                       step=st, cache=layer)
        return x

    def _last_logits(self, x: torch.Tensor) -> torch.Tensor:
        table = self.embed.table if self.cfg.tie_embeddings \
            else self.unembed.table
        return tf.lm_logits(self.final_norm.scale, table, x[:, -1:],
                            self.cfg, self.ctx)[:, 0]

    @torch.inference_mode()
    def prefill(self, batch: dict, cache: dict
                ) -> tuple[torch.Tensor, dict]:
        """batch: ``tokens`` (B, S) (or ``embeds`` (B, S, d)), optional
        ``positions`` (B, S), for the vlm family ``mrope_positions`` (3, B,
        S).  Writes positions 0..S-1 into ``cache`` (``new_cache``) and
        returns (the last position's vocabulary-parallel logits (B,
        V/tp), ``cache``)."""
        self._serving()
        x = self.stage_input(batch)
        positions = batch.get("positions")
        if positions is None:
            positions = positions_of(x[..., 0])
        x = self._serve_blocks(x, positions, self.mrope_positions(batch),
                               tf.StepState("prefill"), cache)
        return self._last_logits(x), cache

    @torch.inference_mode()
    def decode(self, cache: dict, batch: dict
               ) -> tuple[torch.Tensor, dict]:
        """batch: ``tokens`` (B, 1), ``cur_len`` (B,) (the new token's
        position), for the vlm family ``mrope_positions`` (3, B, 1).
        Writes the token into ``cache`` at ``cur_len`` and returns (its
        vocabulary-parallel logits (B, V/tp), ``cache``)."""
        self._serving()
        cur = batch["cur_len"]
        x = self.stage_embed(self.embed.table, batch["tokens"])
        x = self._serve_blocks(x, cur[:, None], self.mrope_positions(batch),
                               tf.StepState("decode", cur), cache)
        return self._last_logits(x), cache


def positions_of(tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) token positions 0..S-1 of every row."""
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)
