"""Carry the JAX package's state over into the port.

PyTorch's and JAX's random generators never give the same draws, so
comparisons of the two start from carried-over state: the parameter tree
(fp32 or bf16), the ZeRO-1 optimizer shards, and the per-bucket
compressor state (PowerSGD ``q``/``err``, the ``err``
of the other schemes, the ``key`` of the stochastic ones, and the
``ef:`` wrapper's ``EFState(inner, residual)`` with its nested inner
state).  Everything arrives as numpy arrays (``jax.device_get`` on the JAX
side, and ``jax.random.key_data`` for a key: two uint32 words); this
module imports neither JAX nor the JAX package.

Under FSDP the JAX tree still holds global arrays: ``load_params`` keeps
this rank's slice of each sharded leaf (``Model.shard_slice``), and
``global_params`` / ``to_global`` gather a rank's shards back into global
tensors (collectives over the FSDP axes: every rank calls them), so that
comparisons run on global arrays.  Under TP the same holds along the
``model`` dim of each leaf (``Model.tp_dims``): the JAX tree's global
arrays at that ``tp`` (vocabulary, q heads and experts padded as
``models.model.param_layout`` pads them) are sliced to this rank's
``model`` index on load and gathered over ``model`` back.  The serving
layouts load the same way (``serving.serve_step``): TP shards; FSDP
shards over the DP axes under ``serve_fsdp``; the 2-D MoE layout, whose
experts are sliced along the expert dim over ``data`` and along
``d_ff`` over ``model`` (``Model.slice_spans``).  A JAX serving tree
arrives as numpy, bf16 (raw 16-bit patterns) or fp32, each leaf in its
own dtype.

The padded global layout of a leaf at one ``tp`` and its logical layout
(``tp = 1``'s shapes) convert both ways (``to_logical``, ``to_padded``,
``relayout``): the vocabulary rows past ``vocab`` (``pad_vocab``), the q
heads of each kv group past its ``g`` in ``head_layout``'s ``(kv,
g_pad, hd)`` order (``wq``/``wo`` of every attention, the zamba2 LoRA
``wq.b`` columns; JAX ``layers.pad_q_columns``), and the experts past
``n_experts`` (``E_pad``, the router's columns with them).  Padding comes
back as zeros: no token reads it (the ids stop at ``vocab`` and the
padded logits are masked, ``local_head_mask`` zeroes the padded heads,
the padded experts get ``-inf`` router logits).  The Mamba2 heads and
the mLSTM heads x v-parts keep one global layout at every ``tp``.  A
checkpoint restored at another ``tp`` goes through ``relayout``.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {dotted key path: array}, in sorted-key (JAX leaf)
    order."""
    out: dict[str, np.ndarray] = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype.  bf16 arrays
    (``ml_dtypes.bfloat16``, which numpy names ``bfloat16``) travel as
    their 16-bit patterns, so every bit arrives, NaN payloads included."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def load_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Copy a JAX parameter tree (global arrays) into ``model`` (same
    names; each leaf of the model's shape, or for an FSDP-sharded model
    of its global shape, of which this rank keeps its slice).  Each
    parameter keeps its dtype; a source of the same dtype is copied bit
    for bit, so a mixed tree (the MoE family's fp32 router and shared
    gate among bf16 leaves) arrives leaf by leaf in its own dtypes."""
    flat = flatten(tree)
    params = dict(model.named_parameters())
    if list(flat) != list(params):
        raise ValueError(f"parameter names differ: {list(flat)} vs "
                         f"{list(params)}")
    with torch.no_grad():
        for name, p in params.items():
            src = to_tensor(flat[name])
            if tuple(src.shape) != tuple(p.shape) and hasattr(
                    model, "shard_slice") and tuple(src.shape) == \
                    model.global_shape(name):
                src = model.shard_slice(name, src)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(src)


def gather_global(t: torch.Tensor, split: Sequence) -> torch.Tensor:
    """``t``, one rank's slice of a global array, gathered along each dim
    over the mesh axes ``split`` names for it (``()``: a whole dim), on
    ``t``'s device: a collective of those axes' groups."""
    from repro_torch.parallel.collectives import all_gather
    t = t.detach()
    for dim, axes in enumerate(split):
        if axes:
            t = all_gather(t, axes, dim)
    return t


def to_global(model: torch.nn.Module, name: str, t: torch.Tensor
              ) -> torch.Tensor:
    """A tensor laid out as leaf ``name``'s local shard (the parameter,
    its gradient, an AdamW moment) gathered over the FSDP axes and over
    ``model`` into the global leaf, on the host.  A collective of the
    FSDP and TP groups; ``t`` itself, on the host, when the leaf is not
    sharded."""
    from repro_torch.models.layers import fsdp_dim
    split = [()] * t.ndim
    axes = tuple(model.ctx.fsdp_axes)
    dim = fsdp_dim(name)
    if axes and dim is not None and getattr(model, "fsdp_size", 1) > 1:
        split[dim % t.ndim] = axes
    tdim = getattr(model, "tp_dims", {}).get(name)
    if tdim is not None:
        split[tdim] += ("model",)
    edim = getattr(model, "ep_dims", {}).get(name)
    if edim is not None and getattr(model, "ep_size", 1) > 1:
        split[edim] += (model.ctx.moe_ep_axis,)
    return gather_global(t, split).cpu()


def global_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """name -> the global parameter on the host, in leaf order (every
    rank of the FSDP group calls it)."""
    return {name: to_global(model, name, p)
            for name, p in model.named_parameters()}


def opt_state(state: Mapping, index: int,
              device: "str | torch.device" = "cpu") -> dict:
    """A JAX ZeRO-1 optimizer state, ``{"t", "shard": {"master", "m",
    "v"}}`` with a leading ``(n_dev, cap)`` device dim, -> the port's:
    ``t`` as an int and rank ``index``'s ``(cap,)`` row of each shard on
    ``device``."""
    return {"t": int(np.asarray(state["t"])),
            "shard": {k: to_tensor(np.asarray(state["shard"][k])[index])
                      .to(device) for k in ("master", "m", "v")}}


def _state(template: tuple, src: Any, index: Optional[int],
           device: "str | torch.device") -> tuple:
    """One JAX state (a NamedTuple, or a mapping of field name -> value)
    -> the port's NamedTuple of ``template``'s type, field by field."""
    fields = {}
    for name, tmpl in zip(template._fields, template):
        a = src[name] if isinstance(src, Mapping) else getattr(src, name)
        if isinstance(tmpl, tuple):              # a nested state
            fields[name] = _state(tmpl, a, index, device)
            continue
        a = np.asarray(a)
        if index is not None:
            a = a[index]
        if name == "key":                        # raw key words: the host
            fields[name] = torch.from_numpy(a.astype(np.int64))
        else:
            fields[name] = torch.from_numpy(np.array(a)).to(device)
    return type(template)(**fields)


def agg_states(compressor, states: Sequence[Any], index: Optional[int] = 0,
               device: "str | torch.device" = "cpu") -> tuple:
    """Per-bucket JAX compressor states -> the port's.  ``index`` picks one
    rank's row of the leading device dim the JAX TrainState carries;
    ``None`` when there is none.  Keys stay on the host."""
    template = compressor.init_state(1, None, device="meta")
    return tuple(_state(template, st, index, device) for st in states)


# --------------------------------------------------------------------------
# the padded global layouts and the logical one
# --------------------------------------------------------------------------
#: the q-head weights of every attention (the dense and vlm blocks, the
#: zamba2 shared block, the audio family's self- and cross-attention): the
#: columns of ``wq`` and the rows of ``wo``
_Q_COLUMNS = ("attn.wq.w", "self.wq.w", "cross.wq.w")
_Q_ROWS = ("attn.wo.w", "self.wo.w", "cross.wo.w")


def padded_dim(name: str) -> "Optional[tuple[str, int]]":
    """(kind, dim counted from the end) of the dim of leaf ``name`` that
    the JAX package pads at ``tp > 1``: ``"vocab"`` (the rows of the
    tables), ``"heads"`` (the q heads: ``wq`` columns, ``wo`` rows, the
    LoRA ``wq.b`` columns), ``"experts"`` (the stacked experts, the
    router's columns); None for a leaf with one layout at every
    ``tp``."""
    if name in ("embed.table", "unembed.table"):
        return "vocab", -2
    if name.endswith(_Q_COLUMNS) or name == "groups.lora.wq.b":
        return "heads", -1
    if name.endswith(_Q_ROWS):
        return "heads", -2
    if name.startswith("blocks.moe.experts."):
        return "experts", -3
    if name == "blocks.moe.router":
        return "experts", -1
    return None


def _layout_sizes(cfg, kind: str, tp: int) -> tuple:
    """The padded dim's shape at ``tp``, and its logical shape: ``(n,)``
    for the vocabulary and the experts, ``(kv, g, hd)`` for the heads."""
    from repro_torch.models.layers import head_layout, pad_vocab
    from repro_torch.models.moe import pad_experts
    if kind == "vocab":
        return (pad_vocab(cfg.vocab, tp),), (cfg.vocab,)
    if kind == "experts":
        e = cfg.moe.n_experts
        return (pad_experts(e, tp),), (e,)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kv
    g_pad = head_layout(cfg.n_heads, kv, hd, tp).g_pad if tp > 1 else g
    return (kv, g_pad, hd), (kv, g, hd)


def _last(arr: np.ndarray, dim: int, shape: tuple) -> np.ndarray:
    """``arr`` with ``dim`` moved last and split into ``shape``."""
    a = np.moveaxis(arr, dim, -1)
    return a.reshape(a.shape[:-1] + tuple(shape))


def _back(a: np.ndarray, k: int, dim: int) -> np.ndarray:
    """The inverse of ``_last``: the ``k`` trailing dims merged and moved
    back to ``dim``."""
    a = a.reshape(a.shape[:a.ndim - k] + (-1,))
    return np.ascontiguousarray(np.moveaxis(a, -1, dim))


def to_logical(cfg, name: str, arr: np.ndarray, tp: int,
               dim: "Optional[int]" = None) -> np.ndarray:
    """``arr``, leaf ``name`` in the JAX package's padded global layout
    at ``tp``, without its padding: the logical layout.  ``dim``: the
    padded dim of ``arr`` when it is not the leaf's own (an optimizer
    statistic of the leaf).  ``arr`` itself for a leaf with no padded
    dim."""
    kd = padded_dim(name)
    if kd is None:
        return arr
    kind, own = kd
    dim = own if dim is None else dim
    padded, logical = _layout_sizes(cfg, kind, tp)
    if padded == logical:
        return arr
    a = _last(arr, dim, padded)
    a = a[(..., *(slice(0, n) for n in logical))]
    return _back(a, len(padded), dim)


def to_padded(cfg, name: str, arr: np.ndarray, tp: int,
              dim: "Optional[int]" = None) -> np.ndarray:
    """The inverse of ``to_logical``: ``arr`` in the logical layout ->
    the padded global layout at ``tp``, the padding zeros of ``arr``'s
    dtype."""
    kd = padded_dim(name)
    if kd is None:
        return arr
    kind, own = kd
    dim = own if dim is None else dim
    padded, logical = _layout_sizes(cfg, kind, tp)
    if padded == logical:
        return arr
    a = _last(arr, dim, logical)
    pad = [(0, 0)] * (a.ndim - len(logical)) \
        + [(0, p - n) for p, n in zip(padded, logical)]
    return _back(np.pad(a, pad), len(padded), dim)


def relayout(cfg, name: str, arr: np.ndarray, tp_from: int, tp_to: int,
             dim: "Optional[int]" = None) -> np.ndarray:
    """``arr`` from the padded global layout at ``tp_from`` to that at
    ``tp_to``, through the logical layout."""
    if tp_from == tp_to:
        return arr
    return to_padded(cfg, name, to_logical(cfg, name, arr, tp_from, dim),
                     tp_to, dim)
