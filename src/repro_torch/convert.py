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
``model`` index on load and gathered over ``model`` back.
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


def to_global(model: torch.nn.Module, name: str, t: torch.Tensor
              ) -> torch.Tensor:
    """A tensor laid out as leaf ``name``'s local shard (the parameter,
    its gradient, an AdamW moment) gathered over the FSDP axes and over
    ``model`` into the global leaf, on the host.  A collective of the
    FSDP and TP groups; ``t`` itself, on the host, when the leaf is not
    sharded."""
    from repro_torch.models.layers import fsdp_dim
    from repro_torch.parallel.collectives import all_gather
    axes = tuple(model.ctx.fsdp_axes)
    dim = fsdp_dim(name)
    t = t.detach()
    if axes and dim is not None and getattr(model, "fsdp_size", 1) > 1:
        t = all_gather(t, axes, dim % t.ndim)
    tdim = getattr(model, "tp_dims", {}).get(name)
    if tdim is not None:
        t = all_gather(t, ("model",), tdim)
    return t.cpu()


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
