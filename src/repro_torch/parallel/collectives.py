"""Axis-aware collectives over the mesh's process groups.  Counterpart of
``repro.parallel.collectives``.

The JAX package runs its model in one ``shard_map`` and names the axes
of each collective; the port maps each set of axes to the process group
of ``launch.mesh.group``.  The conventions are JAX's:

  * the TP axis is ``"model"`` (``TP_AXIS``); the DP axes are ``("pod",
    "data")`` or ``("data",)``;
  * ``psum_tp`` / ``reduce_scatter_tp`` end a row-parallel matmul (the
    reduce-scatter form is Megatron sequence parallelism);
  * ``pmax`` and ``psum`` over any axes merge serving's context-parallel
    attention, and ``all_to_all`` over ``data`` is the dispatch of the
    2-D MoE serving layout;
  * the FSDP gather stays in ``models.layers`` (``fsdp_gather``).

These are plain collectives, outside autograd; the differentiable pairs
built on them are in ``models.layers`` (``tp_copy``, ``tp_reduce``,
``tp_shared``).  Every tiled form moves ``axis`` to the front, runs the
collective on a contiguous tensor, and moves it back.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel.commplan import (_all_gather_single,
                                           _reduce_scatter_single)

TP_AXIS = mesh_mod.TP_AXIS


def tp_index() -> int:
    """This rank's index along ``model`` (0 without the axis)."""
    return mesh_mod.coords().get(TP_AXIS, 0)


def all_gather(t: torch.Tensor, axes: Sequence[str], axis: int
               ) -> torch.Tensor:
    """The tiled all-gather of ``t`` along ``axis`` over ``axes``: the
    shards concatenated in rank order (``jax.lax.all_gather(...,
    tiled=True)``)."""
    src = t.movedim(axis, 0).contiguous()
    p = mesh_mod.size(axes)
    out = torch.empty((p * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _all_gather_single(out, src, group=mesh_mod.group(axes))
    return out.movedim(0, axis)


def reduce_scatter(g: torch.Tensor, axes: Sequence[str], axis: int
                   ) -> torch.Tensor:
    """The tiled sum-reduce-scatter of ``g`` along ``axis`` over ``axes``
    (``jax.lax.psum_scatter(..., tiled=True)``), in ``g``'s dtype, laid
    out contiguously."""
    src = g.movedim(axis, 0).contiguous()
    p = mesh_mod.size(axes)
    out = torch.empty((src.shape[0] // p, *src.shape[1:]), dtype=g.dtype,
                      device=g.device)
    _reduce_scatter_single(out, src, group=mesh_mod.group(axes))
    return out.movedim(0, axis).contiguous()


def psum(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The sum of ``t`` over ``axes``: a new tensor."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=mesh_mod.group(axes))
    return out


def psum_tp(t: torch.Tensor) -> torch.Tensor:
    return psum(t, (TP_AXIS,))


def all_gather_tp(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return all_gather(t, (TP_AXIS,), axis)


def reduce_scatter_tp(t: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Sum over TP and keep this rank's 1/tp slice along ``axis`` (the SP
    form)."""
    return reduce_scatter(t, (TP_AXIS,), axis)


def pmax(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The elementwise maximum of ``t`` over ``axes``: a new tensor."""
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh_mod.group(axes))
    return out


def all_to_all(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``t``'s leading dim split into p equal chunks (p the size of
    ``axes``), chunk ``j`` sent to the rank at index ``j`` along them;
    returns the chunks received, chunk ``i`` from the rank at index ``i``
    (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``)."""
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh_mod.group(axes))
    return out


def broadcast_from_first(tensors: Sequence[torch.Tensor],
                         axes: Sequence[str]) -> None:
    """In place: every tensor takes the bits of the rank at index 0 along
    ``axes``, one collective per dtype (the tensors flattened into one
    buffer of their dtype)."""
    if not tensors:
        return
    group = mesh_mod.group(axes)
    src = mesh_mod.group_rank0(axes)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        at = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[at:at + n].view_as(t))
            at += n
