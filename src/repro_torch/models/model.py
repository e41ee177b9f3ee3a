"""The dense decoder as an ``nn.Module``.  Counterpart of the dense family
of ``repro.models.model.Model`` (init and loss).

The parameters are stored as the JAX package stores them: one stacked
``(n_layers, ...)`` leaf per block weight, weights laid out ``(d_in,
d_out)``, under the JAX tree's key paths joined by dots, and registered in
the JAX tree's leaf order (sorted keys at every level):

    blocks.attn.{wk,wo,wq,wv}.w, blocks.ln1.scale, blocks.ln2.scale,
    blocks.mlp.{down,gate,up}.w, embed.table, final_norm.scale,
    unembed.table

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
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (ShardCtx, embedding_lookup,
                                       trunc_normal_)

BLOCK_PREFIX = "blocks."


def param_layout(cfg) -> list[tuple[str, tuple[int, ...], "float | None"]]:
    """(name, shape, init std; None = ones) of every leaf, in leaf order."""
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    q_out, kv_out = cfg.n_heads * hd, cfg.n_kv_heads * hd
    out = [
        ("blocks.attn.wk.w", (L, d, kv_out), 1 / math.sqrt(d)),
        ("blocks.attn.wo.w", (L, q_out, d), 1 / math.sqrt(q_out)),
        ("blocks.attn.wq.w", (L, d, q_out), 1 / math.sqrt(d)),
        ("blocks.attn.wv.w", (L, d, kv_out), 1 / math.sqrt(d)),
        ("blocks.ln1.scale", (L, d), None),
        ("blocks.ln2.scale", (L, d), None),
        ("blocks.mlp.down.w", (L, cfg.d_ff, d), 1 / math.sqrt(cfg.d_ff)),
        ("blocks.mlp.gate.w", (L, d, cfg.d_ff), 1 / math.sqrt(d)),
        ("blocks.mlp.up.w", (L, d, cfg.d_ff), 1 / math.sqrt(d)),
        ("embed.table", (cfg.vocab, d), 0.02),
        ("final_norm.scale", (d,), None),
    ]
    if not cfg.tie_embeddings:
        out.append(("unembed.table", (cfg.vocab, d), 0.02))
    return out


class Model(nn.Module):
    def __init__(self, cfg, ctx: ShardCtx = ShardCtx(),
                 device: "str | torch.device | None" = None):
        """Parameters of ``ctx.param_dtype``, uninitialised, on ``device``:
        ``cuda`` unless the caller asks for ``cpu`` or ``meta``."""
        super().__init__()
        if cfg.family != "dense" or cfg.qk_norm or cfg.rope != "rope":
            raise NotImplementedError(
                f"{cfg.name}: only the dense RoPE decoder is ported yet")
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
                shape, dtype=ctx.param_dtype, device=device)))
            self._std[name] = std

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

    def stage_block(self, p_l: dict, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
        """One block on one layer's parameters (``p_l``: names under
        ``blocks.`` -> that layer's slice), recomputed in the backward
        pass when ``remat="full"``."""
        if self.cfg.plan.remat == "full" and torch.is_grad_enabled():
            return checkpoint(tf.dense_block_apply, p_l, x, positions,
                              self.cfg, self.ctx, use_reentrant=False)
        return tf.dense_block_apply(p_l, x, positions, self.cfg, self.ctx)

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
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: ``tokens`` and ``labels`` (B, S) on the model's device.
        Returns (local loss sum, local token count)."""
        tokens, labels = batch["tokens"], batch["labels"]
        x = self.stage_embed(self.embed.table, tokens)
        positions = positions_of(tokens)
        stacked = [(name, p.unbind(0)) for name, p in self.block_params()]
        for layer in range(self.cfg.n_layers):
            x = self.stage_block({name: slices[layer]
                                  for name, slices in stacked}, x, positions)
        table = self.embed.table if self.cfg.tie_embeddings \
            else self.unembed.table
        return self.stage_loss(self.final_norm.scale, table, x, labels,
                               xent_chunk)


def positions_of(tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) token positions 0..S-1 of every row."""
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)
