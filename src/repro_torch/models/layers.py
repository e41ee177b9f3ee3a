"""Primitive layers of the dense decoder (the tensor-parallel degree 1
subset of ``repro.models.layers``).

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
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    #: the mesh axes the parameters are sharded over (FSDP); () = none
    fsdp_axes: tuple[str, ...] = ()
    #: "int8" quantizes the FSDP parameter all-gather; None = plain
    gather_quant: "str | None" = None


def _moved(t: torch.Tensor, axis: int) -> torch.Tensor:
    return t.movedim(axis, 0).contiguous()


def _all_gather(t: torch.Tensor, axes: tuple[str, ...], axis: int
                ) -> torch.Tensor:
    """The tiled all-gather of ``t`` along ``axis`` over ``axes``: the
    shards concatenated in rank order (``jax.lax.all_gather(...,
    tiled=True)``)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel.commplan import _all_gather_single
    src = _moved(t, axis)
    p = mesh_mod.size(axes)
    out = torch.empty((p * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _all_gather_single(out, src, group=mesh_mod.group(axes))
    return out.movedim(0, axis)


def _reduce_scatter(g: torch.Tensor, axes: tuple[str, ...], axis: int
                    ) -> torch.Tensor:
    """The tiled sum-reduce-scatter of ``g`` along ``axis`` over ``axes``
    (``jax.lax.psum_scatter(..., tiled=True)``), in ``g``'s dtype, laid
    out contiguously like the shard it is the gradient of."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel.commplan import _reduce_scatter_single
    src = _moved(g, axis)
    p = mesh_mod.size(axes)
    out = torch.empty((src.shape[0] // p, *src.shape[1:]), dtype=g.dtype,
                      device=g.device)
    _reduce_scatter_single(out, src, group=mesh_mod.group(axes))
    return out.movedim(0, axis).contiguous()


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
        return _all_gather(w, axes, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axes, ctx.axis), None, None, None


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


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, ctx: ShardCtx,
                     vocab: int) -> torch.Tensor:
    """ids: (B, S) -> (B, S, d) in the compute dtype (the table gathered
    along d under FSDP)."""
    table = fsdp_gather(table.to(ctx.compute_dtype), ctx, 1)
    return torch.nn.functional.embedding(ids.clamp(max=vocab - 1), table)


def unembed_logits(table: torch.Tensor, x: torch.Tensor,
                   ctx: ShardCtx) -> torch.Tensor:
    """x: (B, S, d) -> logits (B, S, V) (the table gathered along d under
    FSDP)."""
    return x @ fsdp_gather(table.to(ctx.compute_dtype), ctx, 1).T


def vocab_parallel_xent(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy in fp32: logsumexp - gold logit."""
    ll = logits.float()
    lse = torch.logsumexp(ll, dim=-1)
    gold = torch.gather(ll, -1, labels[..., None])[..., 0]
    return lse - gold
