"""Checkpoint manager: rotation, discovery of the newest checkpoint, and
restore into the live state of a ``TrainSetup``, elastic across world
sizes.  Counterpart of ``repro.checkpoint.manager``.

The saved tree is the JAX package's ``TrainState``: ``{"agg", "opt",
"params", "step"}`` with the parameters (and the replicated optimizer's
moments) nested by parameter name, ``step`` and ``t`` as int32 scalars,
and each rank's own leaves (ZeRO-1's ``(cap,)`` master/m/v shards, every
compressor state leaf) stacked over the world.

At the world size of the checkpoint, restore is exact: every leaf comes
back bit for bit, compressor keys included.  On another world size the
per-rank leaves no longer fit and reset (``reset_device_state``), then:

* the whole ``agg`` subtree is rebuilt from ``train_step.fresh_agg_state``
  if any of its leaves was reset (zeros would brick PowerSGD: ``q = 0`` is
  a fixed point of its power iteration), as in JAX; error feedback
  re-accumulates within a few steps;
* under ZeRO-1 the fp32 master is refilled from the restored parameters
  (``train_step._fill_zero1_master``, as ``init_state`` fills it), ``m``
  and ``v`` start at zero and ``t`` is kept.  The JAX package leaves the
  master at zero here, so its next step writes the update of a zero
  master into the parameters (a reduced tinyllama, 4 devices restored on
  2: the master summed to 0.0, mean |param| fell from 0.291 to 0.00073
  after one step and the loss went to ln(vocab)); the port does not copy
  that.

JAX's manager also heals ``agg`` at an equal world size whenever the
compressor state holds a key, because it compares a key's saved words
``(n_dev, 2)`` with the key's own shape ``(n_dev,)``; the port compares the
key's shape, so such a state resumes exactly.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt

#: the seed of the compressor state an elastic restore rebuilds (the JAX
#: manager's ``jax.random.key(17)``)
HEAL_SEED = 17


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
        path = ckpt.save(self.dir, step, to_tree(self.setup, state), cursor)
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
        like = abstract_state(self.setup)
        tree, cursor = ckpt.restore(self.dir, step, like,
                                    reset_device_state=True)
        meta = ckpt.read_meta(self.dir, step)
        saved = {p: ckpt.logical_shape(e)
                 for p, e in zip(meta["paths"], meta["index"])}
        reset = [p for p, leaf in ckpt.items(like)
                 if saved.get(p) != tuple(leaf.shape)]
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


def check_unsharded(setup) -> None:
    """Refuse a state whose parameters FSDP or TP shards: its leaves are
    this rank's slices, a file the JAX package could not read.  Sharded
    checkpoints (FSDP and TP) are a later slice of the port (ROADMAP)."""
    if getattr(setup, "fsdp_axes", ()):
        raise NotImplementedError(
            f"checkpoints of an FSDP state (parameters sharded over "
            f"{tuple(setup.fsdp_axes)}) are not ported yet: a later slice "
            f"(FSDP checkpoints) writes the gathered JAX layout")
    if getattr(setup, "tp", 1) > 1:
        raise NotImplementedError(
            f"checkpoints of a TP state (parameters sharded over model, "
            f"tp={setup.tp}) are not ported yet: a later slice (sharded "
            f"checkpoints) writes the gathered JAX layout")


def to_tree(setup, state: dict) -> dict:
    """The live ``state`` as the JAX package's TrainState tree."""
    check_unsharded(setup)
    names = _names(setup)
    opt = state["opt"]
    if setup.zero1:
        opt_tree = {"t": _int32(opt["t"]),
                    "shard": {k: ckpt.PerRank(v)
                              for k, v in opt["shard"].items()}}
    else:
        opt_tree = {k: _int32(v) if k == "t" else _nest(names, v)
                    for k, v in opt.items()}
    return {"step": _int32(state["step"]),
            "params": _nest(names, state["params"]),
            "opt": opt_tree,
            "agg": tuple(_agg_tree(st) for st in state["agg"])}


def _agg_live(st, device):
    return type(st)(*(
        _agg_live(v, device) if isinstance(v, tuple) else
        v if f == "key" else v.to(device)
        for f, v in zip(st._fields, st)))


@torch.no_grad()
def from_tree(setup, tree: dict) -> dict:
    """A restored tree -> the live state; the model's parameters take the
    restored values in place."""
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
    return ckpt.Leaf(tuple(x.shape), ckpt.dtype_name(x.dtype))


def abstract_state(setup) -> dict:
    """The TrainState tree of ``setup`` as ``Leaf`` shapes and dtypes,
    per-rank leaves with their global ``(world, ...)`` shape; nothing is
    allocated (the tensors it reads live on ``meta``)."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts
    check_unsharded(setup)
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
    tree = to_tree(setup, {"step": 0, "params": params, "opt": opt,
                           "agg": agg})
    return ckpt.rebuild(tree, iter(_leaf(x) for _, x in ckpt.items(tree)))
