"""Atomic checkpoints in the JAX package's on-disk format.  Counterpart of
``repro.checkpoint.checkpoint``.

Layout (one directory per step)::

    <dir>/step_000000123/
        meta.json            # step, cursor, n_leaves, paths, leaf index
        leaf_00000.npy ...   # global logical arrays, one per leaf

Writes go to ``<dir>/.tmp_step_000000123``, then ``os.replace``: a writer
that dies never corrupts the newest checkpoint, and a restart reads the
newest complete directory (every file meta.json lists is there).

A state is a tree of dicts (sorted-key order), lists, tuples and
NamedTuples (field order) over tensors and numpy arrays: the leaf order
and the ``paths`` are JAX's (``['params']/['embed']/['table']``,
``['agg']/[0]/.q``), so either package restores the other's files.  bf16
is stored as its raw bytes (uint8) with ``dtype`` ``"bfloat16"``; a key
as its two uint32 words per row with ``prng`` naming JAX's
implementation, so that JAX can wrap them again.

The JAX package saves global arrays, whose per-device leaves (ZeRO-1
shards, compressor state) carry a leading ``(n_dev,)`` dim.  Here each
rank holds its own row of such a leaf (a ``PerRank`` leaf): ``save``
gathers the rows over the world into the ``(world, ...)`` array (every
rank calls it), rank 0 writes, and a barrier follows; ``restore`` reads
each such file on every rank and keeps the rank's own row.  A leaf whose
saved shape differs from the one asked for (the world size changed)
raises, or with ``reset_device_state`` comes back as zeros, as in JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

#: the key implementation JAX names in ``meta.json`` (the port's own draws
#: from those words are not threefry's)
PRNG_IMPL = "threefry2x32"
#: the trailing dims of a key's words
KEY_WORDS = (2,)


@dataclasses.dataclass(frozen=True)
class PerRank:
    """A leaf each rank holds its own row of (a ZeRO-1 shard, compressor
    state): saved as the ``(world, ...)`` stack of every rank's.  ``prng``
    marks a key, whose value holds its words."""
    value: torch.Tensor
    prng: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Leaf:
    """The global shape and dtype (numpy's name) of a leaf, with no data:
    what ``restore`` reads a file into.  ``per_rank``: the leading dim is
    the world, and each rank gets its own row.  ``prng``: a key, stored
    with ``KEY_WORDS`` beyond ``shape``."""
    shape: tuple
    dtype: str
    per_rank: bool = False
    prng: Optional[str] = None


def items(tree, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` in JAX's leaf order, the path as JAX prints it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from items(v, path + (f".{k}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


def rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken in order from
    ``leaves``."""
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, leaves) for v in tree)
    return next(leaves)


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``"bfloat16"``,
    ``"float32"``, ...)."""
    return str(dtype).removeprefix("torch.")


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _gathered(t: torch.Tensor, rank: int, world: int
              ) -> Optional[torch.Tensor]:
    """The ``(world, ...)`` stack of every rank's ``t`` on rank 0, None on
    the others (a collective)."""
    t = t.detach().contiguous()
    if world == 1:
        return t.unsqueeze(0)
    rows = [torch.empty_like(t) for _ in range(world)] if rank == 0 else None
    dist.gather(t, rows, dst=0)
    return torch.stack(rows) if rank == 0 else None


def _host(leaf) -> tuple[np.ndarray, str, list]:
    """(array to write, dtype name, logical shape) of one leaf on rank 0;
    bf16 becomes its raw bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return (t.reshape(-1).view(torch.uint8).numpy(), "bfloat16",
                    list(t.shape))
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, dtype_name(arr.dtype), list(arr.shape)


def save(dirname: str, step: int, state, cursor: Optional[int] = None
         ) -> str:
    """Atomic write of ``state`` (a collective: every rank calls it, rank 0
    writes).  Returns the step's directory."""
    rank, world = _world()
    final = os.path.join(dirname, f"step_{step:09d}")
    tmp = os.path.join(dirname, f".tmp_step_{step:09d}")
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    paths, index = [], []
    for i, (path, leaf) in enumerate(items(state)):
        prng = None
        if isinstance(leaf, PerRank):
            prng = leaf.prng
            leaf = _gathered(leaf.value, rank, world)
        paths.append(path)
        if rank != 0:
            continue
        arr, dtype, shape = _host(leaf)
        if prng:
            arr, dtype = arr.astype(np.uint32), "uint32"
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        entry = {"file": fn, "shape": shape, "dtype": dtype,
                 "raw": dtype == "bfloat16"}
        if prng:
            entry["prng"] = prng
        index.append(entry)
        del arr, leaf
    if rank == 0:
        meta = {"step": step, "cursor": cursor, "n_leaves": len(index),
                "paths": paths, "index": index}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    if world > 1:
        dist.barrier()
    return final


def read_meta(dirname: str, step: int) -> dict:
    with open(os.path.join(dirname, f"step_{step:09d}", "meta.json")) as f:
        return json.load(f)


def _complete(path: str) -> bool:
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return False
    return all(os.path.exists(os.path.join(path, e["file"]))
               for e in meta["index"])


def list_steps(dirname: str) -> list[int]:
    """The steps of ``dirname``'s complete checkpoints, in order."""
    if not os.path.isdir(dirname):
        return []
    out = []
    for name in os.listdir(dirname):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and _complete(os.path.join(dirname, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def logical_shape(entry: dict) -> tuple:
    """A saved leaf's shape as its state holds it (a key without its
    words)."""
    shape = tuple(entry["shape"])
    return shape[:len(shape) - len(KEY_WORDS)] if entry.get("prng") \
        else shape


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host tensor of ``arr``'s values: bf16 from its raw bytes, uint32
    (a key's words) widened to int64, as the port holds keys."""
    arr = np.array(arr, order="C")             # a copy, 0-d kept
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr)


def _torch_dtype(name: str) -> torch.dtype:
    return torch.int64 if name == "uint32" else getattr(torch, name)


def _read(path: str, entry: dict, want: Leaf, where: str, rank: int,
          reset_device_state: bool) -> torch.Tensor:
    """One leaf, as this rank restores it."""
    if logical_shape(entry) != tuple(want.shape):
        if not reset_device_state:
            raise ValueError(
                f"leaf {where}: checkpoint {logical_shape(entry)} vs state "
                f"{tuple(want.shape)}; pass reset_device_state=True for "
                f"elastic restore (per-device state resets)")
        shape = tuple(want.shape[1:] if want.per_rank else want.shape)
        if want.prng:
            shape += KEY_WORDS
        return torch.zeros(shape, dtype=_torch_dtype(want.dtype))
    arr = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
    shape = tuple(entry["shape"])
    if entry.get("raw"):
        # a flat run of bytes: a rank's row is a contiguous slice of it
        if want.per_rank:
            per = arr.shape[0] // shape[0]
            arr, shape = arr[rank * per:(rank + 1) * per], shape[1:]
        arr = np.asarray(arr).view(np.uint16).reshape(shape)
    elif want.per_rank:
        arr = arr[rank]
    out = _tensor(arr, entry["dtype"])
    want_dtype = _torch_dtype(want.dtype)
    return out if out.dtype == want_dtype else out.to(want_dtype)


def restore(dirname: str, step: int, like, reset_device_state: bool = False):
    """Load ``step`` into the structure of ``like`` (a tree of ``Leaf``).
    Every leaf comes back as a host tensor; a ``per_rank`` leaf as this
    rank's row.  Returns ``(state, cursor)``.  Raises ``ValueError`` when
    the leaf counts differ, and on a shape mismatch unless
    ``reset_device_state`` (the world size changed), which gives zeros."""
    path = os.path.join(dirname, f"step_{step:09d}")
    meta = read_meta(dirname, step)
    wanted = list(items(like))
    if len(wanted) != meta["n_leaves"]:
        raise ValueError(f"checkpoint {path} has {meta['n_leaves']} leaves, "
                         f"the state {len(wanted)}")
    rank, _ = _world()
    out = [_read(path, entry, want, where, rank, reset_device_state)
           for (where, want), entry in zip(wanted, meta["index"])]
    return rebuild(like, iter(out)), meta.get("cursor")
