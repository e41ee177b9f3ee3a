"""The decoder as an ``nn.Module``: the dense and MoE families of
``repro.models.model.Model`` (init and loss).  Counterpart of those
families at tensor-parallel degree 1; ``hybrid``, ``ssm``, ``audio`` and
``vlm`` raise ``NotImplementedError``.

The parameters are stored as the JAX package stores them: one stacked
``(n_layers, ...)`` leaf per block weight, weights laid out ``(d_in,
d_out)``, under the JAX tree's key paths joined by dots, and registered in
the JAX tree's leaf order (sorted keys at every level).  The dense block:

    blocks.attn.{k_norm,q_norm}.scale (qk-norm only),
    blocks.attn.{wk,wo,wq,wv}.w, blocks.ln1.scale, blocks.ln2.scale,
    blocks.mlp.{down,gate,up}.w, embed.table, final_norm.scale,
    unembed.table

The MoE block has ``blocks.moe`` in place of ``blocks.mlp``:
``dense.{down,gate,up}.w`` (the dense residual), ``experts.{down,gate,up}``
(``(L, E, d_ff, d)`` / ``(L, E, d, d_ff)``, with no ``.w``), ``router``
``(L, d, E)``, ``shared.{down,gate,up}.w`` and ``shared_gate`` ``(L, d,
1)``.  ``router`` and ``shared_gate`` are fp32 whatever the parameter
dtype (``moe.FP32_LEAVES``).

``parameters()`` therefore yields the leaves in the order in which the JAX
package ravels its gradient into buckets, which PowerSGD depends on.  The
block loop takes layer ``l``'s slice of each stacked leaf; ``remat="full"``
recomputes each block in the backward pass.  ``loss`` is three stages
(``stage_embed``, ``stage_block`` per layer, ``stage_loss``), which the
overlapped step (``repro_torch.train.overlap``) runs one autograd graph at
a time.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (ShardCtx, embedding_lookup,
                                       trunc_normal_)

BLOCK_PREFIX = "blocks."
#: the families the port builds
FAMILIES = ("dense", "moe")


def _mlp_layout(prefix: str, L: int, d: int, d_ff: int) -> list:
    return [(prefix + "down.w", (L, d_ff, d), 1 / math.sqrt(d_ff)),
            (prefix + "gate.w", (L, d, d_ff), 1 / math.sqrt(d)),
            (prefix + "up.w", (L, d, d_ff), 1 / math.sqrt(d))]


def _moe_layout(cfg) -> list:
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    mc = cfg.moe
    e = moe_mod.pad_experts(mc.n_experts, 1)
    out = _mlp_layout("blocks.moe.dense.", L, d, f) \
        if mc.dense_residual else []
    out += [("blocks.moe.experts.down", (L, e, f, d), 1 / math.sqrt(f)),
            ("blocks.moe.experts.gate", (L, e, d, f), 1 / math.sqrt(d)),
            ("blocks.moe.experts.up", (L, e, d, f), 1 / math.sqrt(d)),
            ("blocks.moe.router", (L, d, e), 0.02)]
    if mc.n_shared:
        out += _mlp_layout("blocks.moe.shared.", L, d, f * mc.n_shared)
        out.append(("blocks.moe.shared_gate", (L, d, 1), 0.02))
    return out


def param_layout(cfg) -> list[tuple[str, tuple[int, ...], "float | None"]]:
    """(name, shape, init std; None = ones) of every leaf, in leaf order."""
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    q_out, kv_out = cfg.n_heads * hd, cfg.n_kv_heads * hd
    out = []
    if cfg.qk_norm:
        out += [("blocks.attn.k_norm.scale", (L, hd), None),
                ("blocks.attn.q_norm.scale", (L, hd), None)]
    out += [
        ("blocks.attn.wk.w", (L, d, kv_out), 1 / math.sqrt(d)),
        ("blocks.attn.wo.w", (L, q_out, d), 1 / math.sqrt(q_out)),
        ("blocks.attn.wq.w", (L, d, q_out), 1 / math.sqrt(d)),
        ("blocks.attn.wv.w", (L, d, kv_out), 1 / math.sqrt(d)),
        ("blocks.ln1.scale", (L, d), None),
        ("blocks.ln2.scale", (L, d), None),
    ]
    if cfg.family == "moe":
        out += _moe_layout(cfg)
    else:
        out += _mlp_layout("blocks.mlp.", L, d, cfg.d_ff)
    out += [("embed.table", (cfg.vocab, d), 0.02),
            ("final_norm.scale", (d,), None)]
    if not cfg.tie_embeddings:
        out.append(("unembed.table", (cfg.vocab, d), 0.02))
    return out


def leaf_dtype(name: str, ctx: ShardCtx) -> torch.dtype:
    """A leaf's storage dtype: fp32 for the MoE router and shared-expert
    gate, ``ctx.param_dtype`` otherwise."""
    fp32 = tuple(BLOCK_PREFIX + n for n in moe_mod.FP32_LEAVES)
    return torch.float32 if name in fp32 else ctx.param_dtype


class Model(nn.Module):
    def __init__(self, cfg, ctx: ShardCtx = ShardCtx(),
                 device: "str | torch.device | None" = None):
        """Parameters of ``leaf_dtype``, uninitialised, on ``device``:
        ``cuda`` unless the caller asks for ``cpu`` or ``meta``."""
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                f"(the port has {', '.join(FAMILIES)})")
        if cfg.rope != "rope":
            raise NotImplementedError(f"{cfg.name}: rope={cfg.rope!r}")
        if cfg.plan.remat not in ("none", "full"):
            raise NotImplementedError(f"remat={cfg.plan.remat!r}")
        if torch.device(device or "cuda").type != "meta":
            device = mesh_mod.resolve_device(device)
        self.cfg = cfg
        self.ctx = ctx
        self._std = {}
        for name, shape, std in param_layout(cfg):
            *path, leaf = name.split(".")
            node: nn.Module = self
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, nn.Module())
                node = getattr(node, part)
            node.register_parameter(leaf, nn.Parameter(torch.empty(
                shape, dtype=leaf_dtype(name, ctx), device=device)))
            self._std[name] = std

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
        for name in self._std:
            yield prefix + ("." if prefix else "") + name, params[name]

    def init_params(self, generator: torch.Generator) -> None:
        """Truncated-normal weights and unit norm scales, drawn in leaf
        order from ``generator``."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                std = self._std[name]
                if std is None:
                    p.fill_(1.0)
                else:
                    trunc_normal_(p, std, generator)

    # ---- the three stages of the loss; the classic step runs them in one
    # ---- autograd graph, the overlapped step one graph per stage ----------
    def stage_embed(self, table: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
        """tokens (B, S) -> the first block's input (B, S, d)."""
        return embedding_lookup(table, tokens, self.ctx, self.cfg.vocab)

    @property
    def has_aux(self) -> bool:
        """Does ``stage_block`` return a load-balancing loss too?"""
        return self.cfg.family == "moe"

    def stage_block(self, p_l: dict, x: torch.Tensor,
                    positions: torch.Tensor):
        """One block on one layer's parameters (``p_l``: names under
        ``blocks.`` -> that layer's slice), recomputed in the backward
        pass when ``remat="full"``.  Returns the block's output, and for
        the MoE family (``has_aux``) ``(output, load-balancing loss)``."""
        fn = moe_mod.moe_block_apply if self.has_aux \
            else tf.dense_block_apply
        if self.cfg.plan.remat == "full" and torch.is_grad_enabled():
            return checkpoint(fn, p_l, x, positions, self.cfg, self.ctx,
                              use_reentrant=False)
        return fn(p_l, x, positions, self.cfg, self.ctx)

    def stage_loss(self, final_scale: torch.Tensor, table: torch.Tensor,
                   x: torch.Tensor, labels: torch.Tensor,
                   xent_chunk: int = 1024
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The last block's output -> (local loss sum, local token count):
        final norm, unembedding and the chunked cross-entropy."""
        return tf.lm_loss(final_scale, table, x, labels, self.cfg, self.ctx,
                          xent_chunk)

    def block_params(self) -> list[tuple[str, torch.Tensor]]:
        """(name under ``blocks.``, stacked ``(L, ...)`` parameter) in leaf
        order."""
        return [(name[len(BLOCK_PREFIX):], p)
                for name, p in self.named_parameters()
                if name.startswith(BLOCK_PREFIX)]

    def loss(self, batch: dict, xent_chunk: int = 1024
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """batch: ``tokens`` and ``labels`` (B, S) on the model's device.
        Returns (local loss sum, local token count, the load-balancing
        loss averaged over the layers: 0 for the dense family)."""
        tokens, labels = batch["tokens"], batch["labels"]
        x = self.stage_embed(self.embed.table, tokens)
        positions = positions_of(tokens)
        stacked = [(name, p.unbind(0)) for name, p in self.block_params()]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in range(self.cfg.n_layers):
            x = self.stage_block({name: slices[layer]
                                  for name, slices in stacked}, x, positions)
            if self.has_aux:
                x, a = x
                aux = aux + a
        table = self.embed.table if self.cfg.tie_embeddings \
            else self.unembed.table
        loss_sum, ntok = self.stage_loss(self.final_norm.scale, table, x,
                                         labels, xent_chunk)
        return loss_sum, ntok, aux / self.cfg.n_layers


def positions_of(tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) token positions 0..S-1 of every row."""
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)
