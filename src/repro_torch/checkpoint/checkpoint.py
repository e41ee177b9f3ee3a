"""Atomic checkpoints in the JAX package's on-disk format.  Counterpart of
``repro.checkpoint.checkpoint``.

Layout (one directory per step)::

    <dir>/step_000000123/
        meta.json            # step, cursor, n_leaves, paths, leaf index,
                             # and the writer's mesh ("layout")
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
implementation, so that JAX can wrap them again.  ``meta.json`` may
carry one more key, ``layout`` (the writer's mesh, ``save(...,
layout=)``); JAX's ``restore`` reads only ``n_leaves``, ``index``,
``paths`` and ``cursor``, so it ignores it.

The JAX package saves global arrays: ``jax.device_get`` gathers every
sharded leaf, and per-device leaves (ZeRO-1 shards, compressor state)
carry a leading ``(n_dev,)`` dim.  Here a leaf comes in three kinds:

* a plain tensor, the same on every rank: rank 0 writes it;
* a ``Sharded`` leaf, of which each rank holds its slice along the dims
  that FSDP and ``model`` shard (a parameter, its AdamW moments,
  Adafactor's statistics): its file holds the global array, into which
  each rank writes its own slice (one replica of it: the rank at index
  0 along the axes that do not split the leaf); ``restore``
  memory-maps the file and copies out only this rank's slice
  (``Leaf.split``), as JAX's ``device_put`` re-shards;
* a ``PerRank`` leaf, each rank's own row (the ZeRO-1 shards, the
  compressor state): its file holds the ``(world, ...)`` array, row
  ``r`` written by world rank ``r`` (the JAX package's device ``r`` of
  the ``(pod, data, model)`` mesh, raveled row-major as the ranks are),
  and ``restore`` keeps the rank's own row.

Nothing is gathered: a host holds one leaf's slice at a time.  Every
rank calls ``save`` (rank 0 makes the files, then every rank writes its
part, between barriers).  A leaf whose saved shape
differs from the one asked for goes through ``Leaf.adapt`` when the
caller gives one (a padded leaf at another ``tp``), else raises, or with
``reset_device_state`` comes back as zeros, as in JAX; so does a leaf the
caller marks ``reset`` (per-rank state of another mesh), which need not
be in the file at all.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
from typing import Any, Callable, Iterator, Optional

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
class Sharded:
    """A leaf of which each rank holds a slice: saved as the global array.
    ``split`` holds, per dim of ``value``, the mesh axes that shard it
    (outermost first; ``()`` for a whole dim)."""
    value: torch.Tensor
    split: tuple


@dataclasses.dataclass(frozen=True)
class Leaf:
    """The global shape and dtype (numpy's name) of a leaf, with no data:
    what ``restore`` reads a file into.  ``per_rank``: the leading dim is
    the world, and each rank gets its own row.  ``prng``: a key, stored
    with ``KEY_WORDS`` beyond ``shape``.  ``split``: per dim, the mesh
    axes that shard it (a ``Sharded`` leaf; each rank gets its slice).
    ``adapt``: takes the saved global array to ``shape`` when the shapes
    differ.  ``reset``: comes back as zeros, unread."""
    shape: tuple
    dtype: str
    per_rank: bool = False
    prng: Optional[str] = None
    split: tuple = ()
    adapt: Optional[Callable[[np.ndarray], np.ndarray]] = None
    reset: bool = False


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


def global_shape(shape: tuple, split: tuple) -> tuple:
    """The global shape of a slice of ``shape`` split along each dim over
    ``split``'s axes."""
    from repro_torch.launch import mesh as mesh_mod
    return tuple(n * (mesh_mod.size(axes) if axes else 1)
                 for n, axes in zip(shape, split))


def own_slices(shape: tuple, split: tuple) -> tuple:
    """This rank's index into a global array of ``shape`` split over
    ``split``'s axes (the slice ``Model.shard_slice`` keeps)."""
    from repro_torch.launch import mesh as mesh_mod
    out = []
    for n, axes in zip(shape, split):
        if not axes:
            out.append(slice(None))
            continue
        k = n // mesh_mod.size(axes)
        at = mesh_mod.rank(axes) * k
        out.append(slice(at, at + k))
    return tuple(out)


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


def _file_layout(leaf, world: int) -> tuple[dict, np.dtype, tuple]:
    """(meta.json entry but the file name, the file's numpy dtype and
    shape) of a per-rank or sharded leaf: its global array, bf16 as a
    flat run of raw bytes, a key's words as uint32."""
    t = leaf.value
    if isinstance(leaf, PerRank):
        shape = (world,) + tuple(t.shape)
    else:
        shape = global_shape(tuple(t.shape), leaf.split)
    dtype = "uint32" if getattr(leaf, "prng", None) else dtype_name(t.dtype)
    entry = {"shape": list(shape), "dtype": dtype,
             "raw": dtype == "bfloat16"}
    if getattr(leaf, "prng", None):
        entry["prng"] = leaf.prng
    if dtype == "bfloat16":
        return entry, np.dtype(np.uint8), (2 * math.prod(shape),)
    return entry, np.dtype(dtype), shape


def _writes(split: tuple) -> bool:
    """Does this rank write its slice of a leaf split over ``split``'s
    axes?  The one at index 0 along every other axis does (its replicas
    hold the same bits)."""
    from repro_torch.launch import mesh as mesh_mod
    used = {a for axes in split for a in axes}
    return all(i == 0 for a, i in mesh_mod.coords().items() if a not in used)


def _write_own(fn: str, leaf, rank: int) -> None:
    """This rank's row (a ``PerRank`` leaf) or slice (a ``Sharded`` one)
    written into its place in the file rank 0 made."""
    t = leaf.value.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.numpy()
    if getattr(leaf, "prng", None):
        arr = arr.astype(np.uint32)
    if isinstance(leaf, PerRank):
        # a row is one run of bytes, raw bf16 or not: a plain write
        with open(fn, "r+b") as f:
            major, _ = np.lib.format.read_magic(f)
            (np.lib.format.read_array_header_1_0 if major == 1 else
             np.lib.format.read_array_header_2_0)(f)
            f.seek(f.tell() + rank * arr.nbytes)
            f.write(memoryview(np.ascontiguousarray(arr)).cast("B"))
        return
    mm = np.load(fn, mmap_mode="r+")
    if arr.dtype == np.int16:                      # bf16: raw bytes
        shape = global_shape(tuple(t.shape), leaf.split)
        mm.view(np.int16).reshape(shape)[own_slices(shape, leaf.split)] = arr
    else:
        mm[own_slices(mm.shape, leaf.split)] = arr
    mm.flush()
    del mm


def save(dirname: str, step: int, state, cursor: Optional[int] = None,
         layout: Optional[dict] = None) -> str:
    """Atomic write of ``state`` (a collective: every rank calls it), with
    the writer's mesh ``layout`` in ``meta.json`` when given.  Rank 0
    writes the plain leaves and makes the file of every per-rank and
    sharded leaf at its global shape; then every rank writes its own row
    or slice into it (one replica of a slice), with no gather.  Returns
    the step's directory."""
    rank, world = _world()
    final = os.path.join(dirname, f"step_{step:09d}")
    tmp = os.path.join(dirname, f".tmp_step_{step:09d}")
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    leaves = list(items(state))
    index, own = [], []
    for i, (path, leaf) in enumerate(leaves):
        fn = f"leaf_{i:05d}.npy"
        if isinstance(leaf, (PerRank, Sharded)):
            entry, dtype, shape = _file_layout(leaf, world)
            if rank == 0:       # the header, and the file at full size
                mm = np.lib.format.open_memmap(os.path.join(tmp, fn),
                                               mode="w+", dtype=dtype,
                                               shape=shape)
                del mm
            if isinstance(leaf, PerRank) or _writes(leaf.split):
                own.append((fn, leaf))
        elif rank == 0:
            arr, dtype, shape = _host(leaf)
            np.save(os.path.join(tmp, fn), arr)
            entry = {"shape": shape, "dtype": dtype,
                     "raw": dtype == "bfloat16"}
        else:
            entry = {}
        index.append({"file": fn, **entry})
    if world > 1:
        dist.barrier()
    for fn, leaf in own:
        _write_own(os.path.join(tmp, fn), leaf, rank)
    if world > 1:
        dist.barrier()
    if rank == 0:
        meta = {"step": step, "cursor": cursor, "n_leaves": len(index),
                "paths": [p for p, _ in leaves], "index": index}
        if layout is not None:
            meta["layout"] = layout
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


def _zeros(want: Leaf) -> torch.Tensor:
    """The zeros a reset leaf comes back as, this rank's part of it."""
    from repro_torch.launch import mesh as mesh_mod
    shape = tuple(want.shape[1:] if want.per_rank else want.shape)
    if want.split:
        shape = tuple(n // mesh_mod.size(axes) if axes else n
                      for n, axes in zip(shape, want.split))
    if want.prng:
        shape += KEY_WORDS
    return torch.zeros(shape, dtype=_torch_dtype(want.dtype))


def _read(path: str, entry: dict, want: Leaf, where: str, rank: int,
          reset_device_state: bool) -> torch.Tensor:
    """One leaf, as this rank restores it."""
    if want.reset:
        return _zeros(want)
    shape = tuple(entry["shape"])
    mismatch = logical_shape(entry) != tuple(want.shape)
    if mismatch and want.adapt is None:
        if not reset_device_state:
            raise ValueError(
                f"leaf {where}: checkpoint {logical_shape(entry)} vs state "
                f"{tuple(want.shape)}; pass reset_device_state=True for "
                f"elastic restore (per-device state resets)")
        return _zeros(want)
    arr = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
    if entry.get("raw"):
        # a flat run of bytes: a rank's row is a contiguous slice of it
        if want.per_rank:
            per = arr.shape[0] // shape[0]
            arr, shape = arr[rank * per:(rank + 1) * per], shape[1:]
        arr = arr.view(np.uint16).reshape(shape)
    elif want.per_rank:
        arr = arr[rank]
    if mismatch:
        arr = want.adapt(np.asarray(arr))
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"leaf {where}: adapted to {arr.shape}, the "
                             f"state has {tuple(want.shape)}")
    if want.split:
        arr = arr[own_slices(tuple(arr.shape), want.split)]
    out = _tensor(arr, entry["dtype"])
    want_dtype = _torch_dtype(want.dtype)
    return out if out.dtype == want_dtype else out.to(want_dtype)


def restore(dirname: str, step: int, like, reset_device_state: bool = False):
    """Load ``step`` into the structure of ``like`` (a tree of ``Leaf``).
    Every leaf comes back as a host tensor: a ``per_rank`` leaf as this
    rank's row, a ``split`` one as this rank's slice, read from the
    memory-mapped file.  The leaves are matched to the file's by path.
    Returns ``(state, cursor)``.  Raises ``ValueError`` when the leaf
    counts differ (unless some leaf is ``reset``) or a leaf that is not
    ``reset`` is missing, and on a shape mismatch without ``adapt``
    unless ``reset_device_state`` (the world size changed), which gives
    zeros."""
    path = os.path.join(dirname, f"step_{step:09d}")
    meta = read_meta(dirname, step)
    wanted = list(items(like))
    if len(wanted) != meta["n_leaves"] and not any(w.reset
                                                  for _, w in wanted):
        raise ValueError(f"checkpoint {path} has {meta['n_leaves']} leaves, "
                         f"the state {len(wanted)}")
    entries = dict(zip(meta["paths"], meta["index"]))
    rank, _ = _world()
    out = []
    for where, want in wanted:
        if not want.reset and where not in entries:
            raise ValueError(f"checkpoint {path} has no leaf {where}")
        out.append(_read(path, entries.get(where), want, where, rank,
                         reset_device_state))
    return rebuild(like, iter(out)), meta.get("cursor")
