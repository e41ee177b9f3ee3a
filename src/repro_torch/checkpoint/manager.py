"""Checkpoint manager: rotation, discovery of the newest checkpoint, and
restore into the live state of a ``TrainSetup``, elastic across world
sizes, FSDP degrees and ``tp``.  Counterpart of
``repro.checkpoint.manager``.

The saved tree is the JAX package's ``TrainState`` at the writer's mesh:
``{"agg", "opt", "params", "step"}`` with the parameters (and the
replicated optimizer's state) nested by parameter name as global arrays
in the layout of the JAX package at that ``tp``
(``models.model.param_layout``: the vocabulary, the q heads and the
experts padded), ``step`` and ``t`` as int32 scalars, and each rank's own
leaves (ZeRO-1's ``(cap,)`` master/m/v shards, every compressor state
leaf) stacked over the world, row ``r`` from world rank ``r``.  Each leaf
FSDP or ``model`` shards is written slice by slice into its global array,
its dims split over the axes ``Sharding.dim_axes`` names (Adafactor's row
and column statistics over the axes of the parameter dims they keep);
a leaf replicated over ``model`` is written once.  ``meta.json``'s ``layout``
records the writer's mesh (``layout_of``: world, ``pod``/``data``/
``model`` sizes, FSDP axes and degree, ``tp``).

Restore reads each rank's slice of every global leaf (``ckpt.restore``
with ``Leaf.split``), and:

* at the writer's layout every leaf comes back bit for bit on every
  rank, compressor keys included;
* at another layout (another world, FSDP degree or ``tp``; told by
  ``layout`` against the reader's, since data 4 x model 1 and data 2 x
  model 2 give per-rank rows of one shape that mean different things;
  a JAX file has no ``layout``, and its per-rank leaves reset where their
  shapes differ, as before) the global leaves are re-sliced, each padded
  leaf at another ``tp`` through ``convert.relayout`` (AdamW's moments
  and Adafactor's statistics with it), and the per-rank leaves reset;
  then (``_heal``) the whole ``agg`` subtree is rebuilt from
  ``train_step.fresh_agg_state`` (zeros would brick PowerSGD: ``q = 0``
  is a fixed point of its power iteration), as in JAX, and under ZeRO-1
  the fp32 master is refilled from the restored parameters
  (``train_step._fill_zero1_master``, as ``init_state`` fills it), ``m``
  and ``v`` start at zero and ``t`` is kept.

Limits of the JAX package that the port does not copy: its manager
always passes ``reset_device_state=True``, so a leaf whose padded shape
changes with ``tp`` comes back as zeros, parameters included; a change in
the number of buckets of the ``1/tp`` shard stops it at its leaf-count
assertion; an elastic restore leaves the ZeRO-1 master at zero (a
reduced tinyllama restored from 4 devices on 2: the master summed to
0.0, mean |param| fell from 0.291 to 0.00073 after one step and the loss
went to ln(vocab)); and it heals ``agg`` at an equal world size whenever
the compressor state holds a key, because it compares a key's saved
words ``(n_dev, 2)`` with the key's own shape ``(n_dev,)``.  The port
compares the key's shape, so such a state resumes exactly.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.launch import mesh as mesh_mod

#: the seed of the compressor state an elastic restore rebuilds (the JAX
#: manager's ``jax.random.key(17)``)
HEAL_SEED = 17
#: the key of ``meta.json`` that records the writer's mesh
LAYOUT_KEY = "layout"


class CheckpointManager:
    def __init__(self, dirname: str, setup, keep: int = 3):
        self.dir = dirname
        self.setup = setup            # train_step.TrainSetup
        self.keep = keep
        os.makedirs(dirname, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: dict, cursor: Optional[int] = None
             ) -> str:
        """Save the live ``state`` (a collective: every rank calls it)."""
        path = ckpt.save(self.dir, step, to_tree(self.setup, state), cursor,
                         layout=layout_of(self.setup))
        if not dist.is_initialized() or dist.get_rank() == 0:
            self._rotate()
        return path

    def _rotate(self) -> None:
        steps = ckpt.list_steps(self.dir)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def restore_latest(self):
        """``(state, cursor)`` of the newest complete checkpoint, or None."""
        steps = ckpt.list_steps(self.dir)
        if not steps:
            return None
        return self.restore(steps[-1])

    def restore(self, step: int):
        """``(state, cursor)``: the live state of ``step`` on this rank, the
        model's parameters overwritten in place."""
        meta = ckpt.read_meta(self.dir, step)
        like, reset = restore_plan(self.setup, meta)
        tree, cursor = ckpt.restore(self.dir, step, like,
                                    reset_device_state=True)
        state = from_tree(self.setup, tree)
        return self._heal(state, reset), cursor

    def _heal(self, state: dict, reset: list) -> dict:
        """After an elastic restore: a fresh ``agg`` if any of its leaves
        reset, and a ZeRO-1 master refilled from the parameters."""
        from repro_torch.train import train_step as ts
        if state["agg"] and any(p.startswith("['agg']") for p in reset):
            state["agg"] = ts.fresh_agg_state(self.setup, HEAL_SEED)
        if self.setup.zero1 and any(p.startswith("['opt']/['shard']")
                                    for p in reset):
            state = ts._fill_zero1_master(self.setup, state)
        return state


def layout_of(setup) -> dict:
    """The mesh a state of ``setup`` lives on, as ``meta.json`` records
    it: the world, the ``pod``/``data``/``model`` sizes, the FSDP axes and
    degree, and ``tp``."""
    sizes = mesh_mod.axis_sizes()
    return {"world": dist.get_world_size() if dist.is_initialized() else 1,
            "pod": sizes.get("pod", 1), "data": sizes.get("data", 1),
            "model": setup.tp, "fsdp_axes": list(setup.fsdp_axes),
            "fsdp": setup.p_fsdp, "tp": setup.tp}


def restore_plan(setup, meta: dict) -> tuple[dict, list]:
    """What restoring the checkpoint of ``meta`` into ``setup`` reads:
    ``abstract_state``'s tree with every per-rank leaf marked ``reset``
    when the writer's layout is another (or, for a JAX file, which has
    none, when its saved shape differs) and every global leaf whose saved
    shape differs given ``convert.relayout`` from the writer's ``tp``;
    and the paths that reset.  ``ValueError`` for a global leaf whose
    shape differs in a file without a layout."""
    like = abstract_state(setup)
    writer = meta.get(LAYOUT_KEY)
    moved = writer is not None and writer != layout_of(setup)
    saved = {p: ckpt.logical_shape(e)
             for p, e in zip(meta["paths"], meta["index"])}
    refs = dict(ckpt.items(_tree(setup, _ref_state(setup),
                                 lambda x, *ref: _Ref(*ref))))
    leaves, reset = [], []
    for path, leaf in ckpt.items(like):
        if leaf.per_rank:
            if moved or saved.get(path) != tuple(leaf.shape):
                leaf = dataclasses.replace(leaf, reset=True)
                reset.append(path)
        elif saved.get(path) != tuple(leaf.shape):
            ref = refs.get(path)
            if writer is None or path not in saved or ref is None:
                raise ValueError(
                    f"leaf {path}: checkpoint {saved.get(path)} vs state "
                    f"{tuple(leaf.shape)}, and the file records no layout "
                    f"to re-lay it out from")
            leaf = dataclasses.replace(leaf, adapt=ref.relayout(
                setup.arch, writer["tp"], setup.tp))
        leaves.append(leaf)
    return ckpt.rebuild(like, iter(leaves)), reset


# --------------------------------------------------------------------------
# the live state <-> the JAX package's TrainState tree
# --------------------------------------------------------------------------
def _names(setup) -> list[str]:
    return [n for n, _ in setup.model.named_parameters()]


def _nest(names, values) -> dict:
    """Dotted parameter names and values -> the nested parameter tree."""
    out: dict = {}
    for name, v in zip(names, values):
        *heads, last = name.split(".")
        d = out
        for h in heads:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _unnest(names, tree) -> list:
    out = []
    for name in names:
        v = tree
        for k in name.split("."):
            v = v[k]
        out.append(v)
    return out


def _int32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


def _agg_tree(st):
    """One compressor state with every leaf marked as this rank's own."""
    return type(st)(*(
        _agg_tree(v) if isinstance(v, tuple) else
        ckpt.PerRank(v, ckpt.PRNG_IMPL if f == "key" else None)
        for f, v in zip(st._fields, st)))


def _stat_dims(key: str, ndim: int) -> tuple:
    """The dims of a parameter of ``ndim`` dims that an optimizer
    statistic keeps: Adafactor's row statistic ``r`` drops the last,
    its column statistic ``c`` the second to last; a moment keeps all."""
    dims = tuple(range(ndim))
    if key == "r":
        return dims[:-1]
    if key == "c":
        return dims[:-2] + dims[-1:]
    return dims


def _sharded(value, split: tuple):
    """``value`` as a ``Sharded`` leaf when some dim is split."""
    return ckpt.Sharded(value, split) if any(split) else value


@dataclasses.dataclass(frozen=True)
class _Ref:
    """A parameter-shaped leaf of the tree: the parameter's name, the
    parameter dims it keeps (``_stat_dims``) and the parameter's rank."""
    name: str
    dims: tuple
    ndim: int

    def relayout(self, cfg, tp_from: int, tp_to: int):
        """The leaf from the padded layout at ``tp_from`` to that at
        ``tp_to`` (``convert.relayout``)."""
        kd = convert.padded_dim(self.name)
        own = None if kd is None else kd[1] % self.ndim
        if own not in self.dims:          # no padded dim, or not kept
            return lambda arr: arr
        dim = self.dims.index(own)
        return lambda arr: convert.relayout(cfg, self.name, arr, tp_from,
                                            tp_to, dim)


def _ref_state(setup) -> dict:
    """A state of ``setup``'s structure on ``meta`` (nothing allocated)."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts
    params = [torch.empty(p.shape, dtype=p.dtype, device="meta")
              for p in setup.model.parameters()]
    if setup.zero1:
        cap = ts._zero1_plan(setup).cap
        opt = {"t": 0, "shard": {**opt_mod.flat_adamw_init(cap, "meta"),
                                 "master": torch.empty(cap, device="meta")}}
    else:
        opt = opt_mod.make(setup.opt_cfg.name, setup.opt_cfg).init(params)
    agg = ()
    if ts._compressed(setup):
        comp = setup.agg_cfg.build()
        agg = tuple(comp.init_state(n, None, device="meta")
                    for n in setup.layout.sizes)
    return {"step": 0, "params": params, "opt": opt, "agg": agg}


def _tree(setup, state: dict, wrap) -> dict:
    """The TrainState tree of ``state``, each parameter-shaped leaf ``x``
    of parameter ``name`` given as ``wrap(x, name, dims, ndim)``
    (``dims``: the parameter dims it keeps, ``ndim`` the parameter's)."""
    names = _names(setup)
    ndims = [p.ndim for p in setup.model.parameters()]

    def moments(values):
        out = []
        for name, n, x in zip(names, ndims, values):
            if isinstance(x, dict):      # Adafactor's statistics of a leaf
                out.append({k: wrap(v, name, _stat_dims(k, n), n)
                            for k, v in x.items()})
            else:
                out.append(wrap(x, name, tuple(range(n)), n))
        return _nest(names, out)
    opt = state["opt"]
    if setup.zero1:
        opt_tree = {"t": _int32(opt["t"]),
                    "shard": {k: ckpt.PerRank(v)
                              for k, v in opt["shard"].items()}}
    else:
        opt_tree = {k: _int32(v) if k == "t" else moments(v)
                    for k, v in opt.items()}
    return {"step": _int32(state["step"]),
            "params": moments(state["params"]),
            "opt": opt_tree,
            "agg": tuple(_agg_tree(st) for st in state["agg"])}


def leaf_splits(setup) -> dict:
    """name -> per dim of the parameter, the mesh axes that shard it."""
    sharding = setup.sharding
    return {name: tuple(sharding.dim_axes(i, p.ndim)) if sharding
            else ((),) * p.ndim
            for i, (name, p) in enumerate(setup.model.named_parameters())}


def to_tree(setup, state: dict) -> dict:
    """The live ``state`` as the JAX package's TrainState tree: every leaf
    FSDP or ``model`` shards as a ``ckpt.Sharded`` slice of its global
    array."""
    splits = leaf_splits(setup)
    return _tree(setup, state, lambda x, name, dims, _: _sharded(
        x, tuple(splits[name][d] for d in dims)))


def _agg_live(st, device):
    return type(st)(*(
        _agg_live(v, device) if isinstance(v, tuple) else
        v if f == "key" else v.to(device)
        for f, v in zip(st._fields, st)))


@torch.no_grad()
def from_tree(setup, tree: dict) -> dict:
    """A restored tree (each rank's slices) -> the live state; the model's
    parameters take the restored values in place."""
    dev = setup.device
    names = _names(setup)
    params = list(setup.model.parameters())
    for p, v in zip(params, _unnest(names, tree["params"])):
        p.copy_(v)
    opt = tree["opt"]
    if setup.zero1:
        live_opt = {"t": int(opt["t"]),
                    "shard": {k: v.to(dev) for k, v in opt["shard"].items()}}
    else:
        live_opt = {k: int(v) if k == "t" else
                    [_to(x, dev) for x in _unnest(names, v)]
                    for k, v in opt.items()}
    return {"step": int(tree["step"]), "params": params, "opt": live_opt,
            "agg": tuple(_agg_live(st, dev) for st in tree["agg"])}


def _to(x, device):
    """A moment tensor, or Adafactor's dict of statistics, on ``device``."""
    if isinstance(x, dict):
        return {k: v.to(device) for k, v in x.items()}
    return x.to(device)


def _leaf(x) -> ckpt.Leaf:
    world = dist.get_world_size() if dist.is_initialized() else 1
    if isinstance(x, ckpt.PerRank):
        shape = tuple(x.value.shape)
        if x.prng:
            return ckpt.Leaf((world,) + shape[:-len(ckpt.KEY_WORDS)],
                             "uint32", True, x.prng)
        return ckpt.Leaf((world,) + shape, ckpt.dtype_name(x.value.dtype),
                         True)
    if isinstance(x, ckpt.Sharded):
        return ckpt.Leaf(ckpt.global_shape(tuple(x.value.shape), x.split),
                         ckpt.dtype_name(x.value.dtype), split=x.split)
    return ckpt.Leaf(tuple(x.shape), ckpt.dtype_name(x.dtype))


def abstract_state(setup) -> dict:
    """The TrainState tree of ``setup`` as ``Leaf`` shapes and dtypes:
    global shapes (a sharded leaf's with its ``split``), per-rank leaves
    with their ``(world, ...)`` shape; nothing is allocated (the tensors
    it reads live on ``meta``)."""
    tree = to_tree(setup, _ref_state(setup))
    return ckpt.rebuild(tree, iter(_leaf(x) for _, x in ckpt.items(tree)))
