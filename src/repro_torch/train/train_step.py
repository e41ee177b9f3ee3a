"""The classic train step: loss -> backward -> bucketed gradient
aggregation (the paper's subject) -> AdamW.  Counterpart of
``repro.train.train_step`` with ``overlap=False``: the ``ddp`` path
below, and the ``fsdp`` path at the end of this docstring.

Each rank holds the full parameters and its own slice of the global
batch.  The gradient leaves are raveled into 25 MB buckets and each bucket
is aggregated by the configured compressor over the DP axes.  Loss scaling
is the JAX package's: ``loss_sum * p_dp / n_tokens_global``, so the mean
over the ranks of the local gradients is the global-mean gradient.

ZeRO-1 (``zero1=True``, the ``tinyllama-1.1b`` default): the parameters
are bf16 working copies and the optimizer state is owner-sharded along
bucket boundaries (``bucketing.owner_plan``).  Each rank runs flat AdamW
(``optimizer.flat_adamw_update``) on the fp32 master of its own
contiguous slice of the flat bucket space and all-gathers the updated bf16
shards, which are copied in place into the model's parameters
(``zero1_apply``).  Under ``comm="reduce_to_owner_broadcast"`` (ZeRO-1
with the ``none`` compressor) the gradient is not aggregated at all: one
reduce-scatter of the owner-aligned raw gradient inside the update is the
step's only gradient collective.  ``param_dtype="bfloat16"`` gives bf16
parameters with the replicated AdamW.

The MoE family adds its load-balancing loss to the differentiated loss
as the JAX package does, ``MOE_AUX_COEF * moe_aux / p_fsdp``, and every
step reports ``moe_aux`` (0 for the other families).  Under ZeRO-1 the
fp32 leaves (the MoE router and shared gate, the Mamba2 ``A_log``, ``D``
and ``dt_bias``, the xLSTM gate weights and biases) ride the bf16 buckets
and the fp32 master, rounded through bf16 as the JAX package's
majority-dtype buckets round them.
Nothing here depends on where a family's stacked leaves sit in the leaf
order: the classic step ravels the parameters in that order, whatever it
is.

``accum > 1`` is the classic accumulation: the step's batch is split into
``accum`` microbatches whose gradients are summed in fp32 and divided by
``accum`` before the aggregation.

``overlap=True`` (``plan.overlap``) swaps in the segmented backward of
``repro_torch.train.overlap``: the buckets are leaf-aligned over the
leaves in backward-completion order (``setup.layout`` is that layout, so
the compressor states and the ZeRO-1 shards key off it) and each bucket
is aggregated as soon as its layers' gradients are final.

Every compressor of the JAX registry runs here, and ``ef:<name>`` for
all but PowerSGD, on the default mesh (one ``data`` axis) or on the
two-tier ``pod x data`` mesh of ``launch.mesh.init_pod_mesh``, where the
DP axes are ``("pod", "data")`` (ZeRO-1's owner plan and rtob's
reduce-scatter run over both, pod-major) and ``plan.compress_axes`` picks
the compressed axes as in the JAX package (``core.aggregator.from_plan``).
The replicated step runs ``plan.optimizer`` (AdamW, SGDM or Adafactor);
ZeRO-1 shards flat AdamW state only, so ``build`` refuses another
optimizer there, where the JAX step fails its assertion at the first
call.  As in JAX, ``build`` reads the plan's static fields only:
``plan.adaptive`` is resolved before it, by
``adaptive.controller.resolve_plan``.  ``build`` raises
``NotImplementedError`` on what later slices port (parameter dtypes but
fp32 and bf16).  Like the JAX ``build``, it
drops reduction axes of size 1 from the aggregation (on one rank the
compressor is not run unless the caller points ``agg_cfg`` back at the
``data`` axis) and checks a ``hierarchical`` plan against the remaining
axes.  ZeRO-1's own collectives run over the DP axes whatever their size.
``local_sgd_sync`` is the pod-axis parameter mean of local SGD.

FSDP (``dp_mode="fsdp"``): the parameters are sharded over
``setup.fsdp_axes``, which are ``data``, and ``pod`` too under
``plan.fsdp_shard_pods`` (full ZeRO-3), less the axes of size 1 (on one
rank the step runs unsharded, as the JAX package's does).  Each leaf that
``layers.fsdp_dim`` names holds this rank's slice and is gathered at use;
the gather's backward is the reduce-scatter of the gradient
(``layers.fsdp_gather``).  The loss scale is ``p_dp / (n_global *
p_fsdp)``, so that the reduce-scatter's sum over the FSDP axes and the
mean over the remaining DP axes land on the global-mean gradient; a
leaf that is not sharded (norms, routers, gates) gets the sum over the
FSDP axes explicitly (``norm_replicated_over_fsdp``).  The compressor runs
on the DP axes not folded into FSDP, over buckets of the local shards:
under HSDP (``pod x data``, FSDP over ``data``) that is the ``pod``
exchange of gradient shards, where the bandwidth is scarce; under
``fsdp_shard_pods`` no DP exchange is left.  The optimizer sums its
global norm (and Adafactor its factored means) over the FSDP axes
(``optimizer.Sharding``).  ZeRO-1 is DDP only, and the overlapped step
refuses FSDP with the JAX package's ``ValueError``.

Tensor parallelism (a mesh with a ``model`` axis: ``launch.mesh.init_mesh``
or ``init_pod_mesh(..., tp=)``; every family):
``build`` reads the degree from the mesh and builds ``ShardCtx(tp=...,
seq_parallel=plan.seq_parallel and tp > 1)``, as the JAX package does.
The DP axes stay ``pod``/``data``: every DP reduction (the loss's token
count, the buckets, ZeRO-1's owner plan and its collectives) runs on
this rank's local leaves over the DP group of its model index, so the
compressors see each model rank's 1/tp shard, the paper's quantity under
such a mesh.  Each rank's batch is the rows of its DP coordinate
(``split_batch`` with ``mesh.rank(dp_axes)``), the same on every model
rank.  The gradients are the loss's, once (``models.layers``); where a
leaf replicated over ``model`` rides a lossy compressor with each model
rank's other leaves, the ranks would receive different values, so the
update first gives every model rank the aggregated gradient of those
leaves from model rank 0 (``sync_model_replicated``), and the replicas
stay bit-identical.  The optimizer sums its global norm over ``model``
for the leaves ``model`` shards (``optimizer.Sharding``); under SP the
MoE load-balancing loss is each rank's own tokens' and enters the loss
divided by ``tp`` too (the mean over the model ranks).

A batch carrying ``mrope_positions`` (the vlm family, ``(3, B, S)``) is
split over ranks on dim 1 (``split_batch``).  The JAX package's
microbatch split reshapes every leaf on dim 0 and fails on it at
``accum > 1``; the port raises ``ValueError`` there rather than guess.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import aggregator as agg_mod
from repro_torch.core import bucketing
from repro_torch.core.compression import base as cbase
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.layers import ShardCtx, fsdp_dim
from repro_torch.models.model import FAMILIES, Model
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import commplan as cp
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import overlap as overlap_mod

#: offset of the compressor-state seed from the parameter seed.
AGG_SEED_OFFSET = 7
#: weight of the MoE load-balancing loss in the differentiated loss
MOE_AUX_COEF = 0.01


@dataclasses.dataclass
class TrainSetup:
    """Everything needed to init and run DDP training of one arch."""
    arch: ArchConfig
    model: Model
    device: torch.device
    dp_axes: tuple[str, ...]
    agg_cfg: agg_mod.AggregatorConfig
    opt_cfg: opt_mod.OptConfig
    layout: Optional[bucketing.BucketLayout]
    zero1: bool = False
    # the segmented backward with each bucket aggregated between backward
    # stages (repro_torch.train.overlap); implies the leaf-aligned layout
    overlap: bool = False
    # the axes the parameters are sharded over (dp_mode="fsdp"); () = none
    fsdp_axes: tuple[str, ...] = ()
    # the size of the mesh's model axis (tensor and expert parallelism)
    tp: int = 1

    @property
    def comm(self) -> cp.CommPlan:
        return self.agg_cfg.comm

    @property
    def rtob(self) -> bool:
        """Is the reduce-to-owner/broadcast path active?  Then gradients
        are not bucket-aggregated: the update's owner-aligned
        reduce-scatter is the only gradient collective, and the updated
        parameters ride the broadcast (gather) leg."""
        return (self.zero1 and self.agg_cfg.compressor == "none"
                and self.comm.kind == "reduce_to_owner_broadcast")

    @property
    def p_dp(self) -> int:
        return cp.axes_p(self.dp_axes)

    @property
    def p_fsdp(self) -> int:
        """The FSDP degree (1 without FSDP axes), which divides the loss
        scale and the MoE loss term."""
        return cp.axes_p(self.fsdp_axes) if self.fsdp_axes else 1

    @property
    def aux_div(self) -> int:
        """The MoE load-balancing loss enters the differentiated loss as
        ``MOE_AUX_COEF * moe_aux / aux_div``: ``p_fsdp``, times ``tp``
        under SP (each model rank's term is its own tokens')."""
        sp = self.model.ctx.seq_parallel and self.tp > 1
        return self.p_fsdp * (self.tp if sp else 1)

    @property
    def sharding(self) -> "Optional[opt_mod.Sharding]":
        """The optimizer's view of the FSDP and TP sharding, None
        without either."""
        if not self.fsdp_axes and self.tp == 1:
            return None
        named = list(self.model.named_parameters())
        tp = ()
        if self.tp > 1:
            tp = tuple(None if self.model.tp_dims[n] is None
                       else self.model.tp_dims[n] - p.ndim
                       for n, p in named)
        return opt_mod.Sharding(
            tuple(self.fsdp_axes),
            tuple(fsdp_dim(name) if self.fsdp_axes else None
                  for name, _ in named), tp)

    def model_replicated(self) -> list[bool]:
        """Per parameter (parameter order): is it replicated over a
        ``model`` axis of more than one rank?"""
        return [self.tp > 1 and self.model.tp_dims[n] is None
                for n, _ in self.model.named_parameters()]


def _check_ported(arch: ArchConfig, plan) -> None:
    if plan.dp_mode not in ("ddp", "fsdp"):
        raise ValueError(f"dp_mode={plan.dp_mode!r}")
    todo = []
    if arch.family not in FAMILIES:
        todo.append(f"the {arch.family!r} family")
    if plan.param_dtype not in ("float32", "bfloat16"):
        todo.append(f"param_dtype={plan.param_dtype!r}")
    if todo:
        raise NotImplementedError(
            f"not ported yet: {', '.join(todo)} (this port runs the DDP "
            f"step, classic or overlapped, with or without ZeRO-1, and the "
            f"FSDP step)")


def build(arch: ArchConfig, device: "str | torch.device | None" = None,
          opt_cfg: Optional[opt_mod.OptConfig] = None,
          **plan_overrides) -> TrainSetup:
    """Set up DDP training of ``arch`` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``).  Joins a process group if this process has
    none (see ``launch.mesh.init_world``)."""
    plan = dataclasses.replace(arch.plan, **plan_overrides) \
        if plan_overrides else arch.plan
    arch = dataclasses.replace(arch, plan=plan)
    zero1 = plan.dp_mode == "ddp" and plan.zero1
    if cp.CommPlan.parse(plan.comm).kind == "reduce_to_owner_broadcast" \
            and not zero1:
        raise cp.CommPlanError(
            "comm='reduce_to_owner_broadcast' needs an owner-sharded "
            "update: dp_mode='ddp' with zero1=True")
    ocfg = opt_cfg or opt_mod.OptConfig(name=plan.optimizer)
    if zero1 and ocfg.name != "adamw":
        raise ValueError(f"zero1 shards flat AdamW state; optimizer="
                         f"{ocfg.name!r} runs on the replicated step "
                         f"(zero1=False)")
    if plan.overlap:
        overlap_mod.check_supported(arch, plan)
    dev = mesh_mod.resolve_device(device)
    mesh_mod.init_world(dev)
    sizes = mesh_mod.axis_sizes()
    dp_axes = mesh_mod.present_axes()
    tp = mesh_mod.tp_size()
    _check_ported(arch, plan)
    if plan.dp_mode == "fsdp":
        fsdp_axes = tuple(a for a in dp_axes
                          if (a != "pod" or plan.fsdp_shard_pods)
                          and sizes.get(a, 1) > 1)
    else:
        fsdp_axes = ()
    agg_cfg = agg_mod.from_plan(plan, multi_pod=sizes["pod"] > 1)
    if plan.dp_mode == "fsdp":
        # the compressor runs only on the DP axes not folded into FSDP
        agg_cfg = dataclasses.replace(
            agg_cfg,
            compress_axes=tuple(a for a in agg_cfg.compress_axes
                                if a not in fsdp_axes
                                and sizes.get(a, 1) > 1),
            raw_axes=())
    else:
        agg_cfg = dataclasses.replace(
            agg_cfg,
            compress_axes=tuple(a for a in agg_cfg.compress_axes
                                if sizes.get(a, 1) > 1),
            raw_axes=tuple(a for a in agg_cfg.raw_axes
                           if sizes.get(a, 1) > 1))
    # fail at build time, not mid-step, when a hierarchical plan's intra
    # stage would be empty over the actual reduction axes
    agg_cfg.comm.validate_axes(agg_cfg.raw_axes + agg_cfg.compress_axes)
    # ZeRO-1: the replicated parameters are bf16 working copies and the
    # fp32 master lives in the owner-sharded optimizer state;
    # param_dtype="bfloat16" gives bf16 weights with fp32 optimizer stats
    bf16 = zero1 or plan.param_dtype == "bfloat16"
    ctx = ShardCtx(param_dtype=torch.bfloat16 if bf16 else torch.float32,
                   fsdp_axes=fsdp_axes,
                   gather_quant=None if plan.gather_quant == "none"
                   else plan.gather_quant,
                   tp=tp,
                   seq_parallel=bool(plan.seq_parallel and tp > 1))
    setup = TrainSetup(arch=arch, model=Model(arch, ctx, device=dev),
                       device=dev, dp_axes=dp_axes, agg_cfg=agg_cfg,
                       opt_cfg=ocfg,
                       layout=None, zero1=zero1, overlap=plan.overlap,
                       fsdp_axes=fsdp_axes, tp=tp)
    setup.layout = _bucket_layout(setup)
    return setup


def _bucket_layout(setup: TrainSetup) -> bucketing.BucketLayout:
    """The layout the compressor states and the ZeRO-1 shards key off: the
    overlapped step's leaf-aligned layout over the backward-completion
    order, else the byte-based split of the parameter order."""
    if setup.overlap:
        return overlap_mod.build_layout(setup).layout
    return bucketing.layout_for(list(setup.model.parameters()),
                                setup.agg_cfg.bucket_mb)


def _flat_order(setup: TrainSetup, leaves: Sequence[torch.Tensor]
                ) -> list[torch.Tensor]:
    """``leaves`` (parameter order) in the leaf order of ``setup.layout``'s
    flat space: per-layer views in backward-completion order under
    overlap."""
    if setup.overlap:
        return overlap_mod._ordered_leaves(overlap_mod.build_layout(setup),
                                           leaves)
    return list(leaves)


def _compressed(setup: TrainSetup) -> bool:
    return setup.agg_cfg.compressor != "none" \
        and bool(setup.agg_cfg.compress_axes)


def init_state(setup: TrainSetup, seed: int = 0) -> dict:
    """Fresh parameters from ``seed`` and zero optimizer and compressor
    state (under ZeRO-1: this rank's ``(cap,)`` fp32 shards, the master
    filled from the parameters).  PowerSGD's warm starts and the
    stochastic compressors' keys are drawn bucket by bucket from one
    generator of a second seed, so every bucket has its own and every rank
    the same (QSGD and TernGrad fold the rank into their draws; RandomK
    needs the same indices on every rank)."""
    dev = setup.device
    setup.model.init_params(torch.Generator(device=dev).manual_seed(seed))
    params = list(setup.model.parameters())
    state = {"step": 0, "params": params}
    if setup.zero1:
        cap = _zero1_plan(setup).cap
        state["opt"] = {"t": 0, "shard": opt_mod.flat_adamw_init(cap, dev)}
        state = _fill_zero1_master(setup, state)
    else:
        opt = opt_mod.make(setup.opt_cfg.name, setup.opt_cfg, setup.sharding)
        state["opt"] = opt.init(params)
    state["agg"] = fresh_agg_state(setup, seed + AGG_SEED_OFFSET)
    return state


def fresh_agg_state(setup: TrainSetup, seed: int) -> tuple:
    """This rank's per-bucket compressor state as ``init_state`` builds
    it, drawn bucket by bucket from one generator seeded with ``seed``
    (``()`` when nothing is compressed); also what an elastic restore
    puts in place of saved state the new world cannot use."""
    if not _compressed(setup):
        return ()
    dev = setup.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    comp = setup.agg_cfg.build()
    return tuple(comp.init_state(n, gen, dev) for n in setup.layout.sizes)


# --------------------------------------------------------------------------
# ZeRO-1
# --------------------------------------------------------------------------
def _zero1_plan(setup: TrainSetup) -> bucketing.OwnerPlan:
    """The bucket -> owner-rank sharding of the optimizer state (shard
    boundaries are the bucket boundaries of ``setup.layout``)."""
    return bucketing.owner_plan(setup.layout, setup.p_dp)


def _zero1_flat(layout: bucketing.BucketLayout,
                leaves: Sequence[torch.Tensor], start: int,
                out: torch.Tensor,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out`` <- the fp32 range ``[start, start + len(out))`` of the
    owner-sliceable flat vector: the leaves (each times ``scale`` in its
    dtype, when given) raveled into buckets of the layout's dtype, cast
    to fp32 and zero-padded past the end.  The JAX package builds that
    vector and slices it; the port copies the range leaf by leaf, so the
    flat vector never exists."""
    return bucketing.read_flat(leaves, start, out, layout.dtype, scale)


def _zero1_own_slice(setup: TrainSetup, layout: bucketing.BucketLayout,
                     plan: bucketing.OwnerPlan,
                     leaves: Sequence[torch.Tensor],
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This DP rank's owned shard, ``(cap,)`` fp32 (of the leaves times
    ``scale``, when given)."""
    out = torch.empty(plan.cap, dtype=torch.float32, device=setup.device)
    return _zero1_flat(layout, leaves,
                       plan.starts[mesh_mod.rank(setup.dp_axes)], out, scale)


def _rtob_norm_weights(setup: TrainSetup, plan: bucketing.OwnerPlan,
                       sizes: Sequence[int],
                       replicated: Sequence[bool]) -> torch.Tensor:
    """(cap,) fp32 weights of this rank's owned range for the global norm
    at ``tp > 1``: 1 on the elements of leaves ``model`` shards, ``1 /
    tp`` on those of leaves it replicates, whose squares the sum over
    ``model`` counts ``tp`` times; 0 past the owned length.  ``sizes``
    and ``replicated`` are per leaf of the flat space, in its order."""
    w = torch.zeros(plan.cap, dtype=torch.float32, device=setup.device)
    start = plan.starts[mesh_mod.rank(setup.dp_axes)]
    end = start + plan.lengths[mesh_mod.rank(setup.dp_axes)]
    at = 0
    for n, rep in zip(sizes, replicated):
        lo, hi = max(at, start), min(at + n, end)
        if lo < hi:
            w[lo - start:hi - start] = 1.0 / setup.tp if rep else 1.0
        at += n
    return w


def _zero1_rtob_own_grad(setup: TrainSetup, layout: bucketing.BucketLayout,
                         plan: bucketing.OwnerPlan,
                         grads: Sequence[torch.Tensor],
                         weights: Optional[torch.Tensor] = None):
    """The ``reduce_to_owner_broadcast`` gradient leg: lay the RAW local
    gradient out as owner-aligned ``(p_dp · cap)`` fp32 tiles and run ONE
    reduce-scatter, so each rank receives the sum of exactly its owned
    shard; ``/ p_dp`` makes it the mean.  The global norm of the mean
    gradient is the square root of the psum of each rank's owned sum of
    squares (the cap-padded tail of a tile overlaps the next rank's region
    and does not count), and the clip scales the shard as
    ``clip_by_global_norm`` scales the leaves.  At ``tp > 1`` the squares
    are weighted by ``weights`` (``_rtob_norm_weights``) and summed over
    ``model`` too.

    Returns ``(g_own_mean_clipped, grad_norm)``."""
    cap, p = plan.cap, setup.p_dp
    dp = setup.dp_axes
    tiles = torch.empty(p * cap, dtype=torch.float32, device=setup.device)
    for r, s in enumerate(plan.starts):
        _zero1_flat(layout, grads, s, tiles[r * cap:(r + 1) * cap])
    g_own = cp.owner_reduce_scatter(tiles, dp)
    del tiles
    g_own.div_(p)
    if weights is None:
        owned = g_own[:plan.lengths[mesh_mod.rank(dp)]]
        gnorm = cp.psum(torch.dot(owned, owned), dp).sqrt()
    else:
        gnorm = cp.psum(torch.dot(g_own * weights, g_own),
                        (*dp, "model")).sqrt()
    c = setup.opt_cfg
    if c.grad_clip:
        g_own.mul_(torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12),
                               max=1.0))
    return g_own, gnorm


def zero1_apply(setup: TrainSetup, layout: bucketing.BucketLayout,
                plan: bucketing.OwnerPlan, params: list, grads: list,
                opt_state: dict, lr: float,
                sharding: "Optional[opt_mod.Sharding]" = None,
                norm_weights: Optional[torch.Tensor] = None):
    """Owner-sharded ZeRO-1 AdamW step:

      1. clip grads by global norm (as ``AdamW.update`` does; the scale
         is applied to the owned range only),
      2. slice this rank's owned range out of the aggregated gradient —
         or, under ``reduce_to_owner_broadcast``, reduce the raw gradient
         straight to its owners (``_zero1_rtob_own_grad``),
      3. flat AdamW on the fp32 master shard (``flat_adamw_update``),
      4. all-gather the updated bf16 shards through the Payload reduce
         machinery (a parameter shard is a non-associative payload),
      5. copy the gathered pieces in place into the parameters
         (``OwnerPlan.pieces``; a bucket split across owners is the
         concatenation of its per-owner slices).

    ``sharding`` is that of ``grads``, in their order (TP: the global
    norm sums over ``model``), ``norm_weights`` the rtob norm's
    (``_rtob_norm_weights``).  ``grads`` (a list) is emptied once read.
    Returns ``(params, new_opt_state, grad_norm)``."""
    c = setup.opt_cfg
    t = opt_state["t"] + 1
    if setup.rtob:
        g_own, gnorm = _zero1_rtob_own_grad(setup, layout, plan, grads,
                                            norm_weights)
    else:
        # the clip of ``clip_by_global_norm``, applied to the owned range
        # only: the same bits, without a clipped copy of every leaf
        gnorm = opt_mod.global_norm(grads, sharding)
        scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0) if c.grad_clip else None
        g_own = _zero1_own_slice(setup, layout, plan, grads, scale)
    # the gradient is read: the caller's list is emptied so that its
    # tensors go before the parameter gather (the callers read it no more)
    grads.clear()
    st = opt_state["shard"]
    master, mv = opt_mod.flat_adamw_update(
        st["master"], g_own, {"m": st["m"], "v": st["v"]}, t, lr, c)
    del g_own
    payload = cbase.Payload({"shard": master.to(layout.dtype)},
                            associative=False)
    flat_p = cbase.reduce_payload(payload, setup.dp_axes) \
        .tensors["shard"].reshape(-1)                # (p_dp · cap,)
    del payload
    for b in range(layout.n_buckets):
        pos = plan.bucket_offsets[b]
        for off, ln in plan.pieces[b]:
            bucketing.write_flat(params, pos, flat_p[off:off + ln])
            pos += ln
    return params, {"t": t, "shard": {"master": master, **mv}}, gnorm


def make_update_fn(setup: TrainSetup, layout: bucketing.BucketLayout,
                   ov: "Optional[overlap_mod.OverlapLayout]" = None):
    """The optimizer leg shared by the classic, overlapped and unfused
    steps: ``update(params, grads, opt_state, lr) -> (params, new_opt,
    grad_norm)`` — owner-sharded flat AdamW under ZeRO-1, the configured
    optimizer otherwise.  ``params`` are the model's parameters in
    parameter order.  With ``ov`` (the overlapped steps) ``grads`` are the
    ordered leaves of ``ov``: ZeRO-1 reads them as they are and writes
    through the per-layer parameter views ``p[l]`` in the same order (in
    place, so autograd keeps its leaves); the replicated optimizer gets
    them stacked back.  At ``tp > 1`` the leaves replicated over
    ``model`` first take model rank 0's aggregated gradient
    (``sync_model_replicated``)."""
    order = overlap_mod._ordered_index(ov) if ov \
        else list(range(len(list(setup.model.parameters()))))
    replicated = setup.model_replicated()
    synced = [i for i, at in enumerate(order) if replicated[at]]
    if setup.zero1:
        plan = _zero1_plan(setup)
        sharding = setup.sharding.reordered(order) \
            if setup.sharding is not None else None
        weights = _rtob_norm_weights(
            setup, plan, [v.numel() for v in _flat_order(
                setup, list(setup.model.parameters()))],
            [replicated[at] for at in order]) \
            if setup.rtob and setup.tp > 1 else None

        def update(params, grads, opt_state, lr):
            sync_model_replicated([grads[i] for i in synced])
            views = overlap_mod._ordered_leaves(ov, params) if ov else params
            _, new_opt, gnorm = zero1_apply(setup, layout, plan, views,
                                            grads, opt_state, lr, sharding,
                                            weights)
            return params, new_opt, gnorm
    else:
        opt = opt_mod.make(setup.opt_cfg.name, setup.opt_cfg, setup.sharding)

        def update(params, grads, opt_state, lr):
            sync_model_replicated([grads[i] for i in synced])
            if ov:
                grads = overlap_mod._unordered_tree(ov, grads)
            params, new_opt, om = opt.update(grads, opt_state, params, lr)
            return params, new_opt, om["grad_norm"]
    return update


def sync_model_replicated(grads: Sequence[torch.Tensor]) -> None:
    """In place: the gradients of leaves replicated over ``model`` take
    the bits of model rank 0's (a no-op without such leaves).  They are
    the same on every model rank out of the backward, and stay so through
    an exact aggregation; a lossy compressor mixes each bucket's leaves,
    which differ across ``model``, and would give each model rank other
    values."""
    if grads:
        coll.broadcast_from_first(list(grads), ("model",))


def train_metrics(setup: TrainSetup, loss_sum: torch.Tensor,
                  n_glob: torch.Tensor, gnorm: torch.Tensor,
                  moe_aux: torch.Tensor) -> dict:
    """The step's metrics (loss is the DP-global token mean; ``moe_aux``
    this rank's load-balancing loss averaged over the layers, 0 but for
    the MoE family)."""
    loss_g = cp.psum(loss_sum, setup.dp_axes)
    return {"loss": loss_g / torch.clamp(n_glob.float(), min=1.0),
            "tokens": n_glob, "grad_norm": gnorm, "moe_aux": moe_aux}


@torch.no_grad()
def _fill_zero1_master(setup: TrainSetup, state: dict) -> dict:
    """Set this rank's fp32 master to its owned slice of the parameters
    (which are bf16 under ZeRO-1, so the master holds their exact
    values)."""
    master = _zero1_own_slice(setup, setup.layout, _zero1_plan(setup),
                              _flat_order(setup, state["params"]))
    shard = {**state["opt"]["shard"], "master": master}
    state["opt"] = {**state["opt"], "shard": shard}
    return state


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------
def _to_device(batch: dict, device: torch.device) -> dict:
    """A batch on ``device``: integer arrays (tokens, labels,
    ``mrope_positions``) as int64, float arrays (``enc_embeds``,
    ``embeds``) in their own dtype."""
    out = {}
    for k, v in batch.items():
        t = v.to(device) if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v), device=device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


#: batch inputs whose batch dim is not the first: ``mrope_positions``
#: (3, B, S) (the JAX package's ``make_batch_specs``)
BATCH_DIM = {"mrope_positions": 1}


def split_batch(batch: dict, n: int, i: int) -> dict:
    """The ``i``-th of ``n`` equal row blocks of ``batch``: this rank's
    share of a global batch (or a microbatch), each input split on its
    batch dim (``BATCH_DIM``, else 0)."""
    out = {}
    for k, v in batch.items():
        dim = BATCH_DIM.get(k, 0)
        rows = v.shape[dim]
        if rows % n:
            raise ValueError(f"{k}: {rows} rows do not split into {n}")
        per = rows // n
        sl = [slice(None)] * v.ndim
        sl[dim] = slice(i * per, (i + 1) * per)
        out[k] = v[tuple(sl)]
    return out


def microbatches(batch: dict, accum: int) -> list[dict]:
    """``batch`` split into ``accum`` microbatches.  A batch with
    ``mrope_positions`` at ``accum > 1`` raises ``ValueError``: the JAX
    package reshapes every leaf on dim 0 and fails on its (3, B, S)
    layout, so there is no reference to follow."""
    if accum > 1 and "mrope_positions" in batch:
        raise ValueError(
            "accum > 1 with mrope_positions: the JAX package's microbatch "
            "split reshapes (3, B, S) on dim 0 and fails; not supported")
    rows = next(iter(batch.values())).shape[0]
    if rows % accum:
        raise ValueError(f"{rows} rows do not split into {accum} "
                         f"microbatches")
    return [split_batch(batch, accum, i) for i in range(accum)]


def local_grads(setup: TrainSetup, batch: dict,
                params: Optional[Sequence[torch.Tensor]] = None,
                xent_chunk: int = 1024):
    """(this rank's gradients of the scaled loss, in the parameters'
    dtype and order, before any aggregation; local loss sum; global token
    count; MoE loss) of one batch on the device.  The scale is the
    step's: ``loss_sum * (p_dp / p_fsdp) / n_global``, plus the MoE term
    ``MOE_AUX_COEF * moe_aux / aux_div``."""
    params = list(setup.model.parameters()) if params is None else params
    loss_sum, ntok, aux = setup.model.loss(batch, xent_chunk)
    n_glob = cp.psum(ntok, setup.dp_axes)
    scaled = loss_sum * ((setup.p_dp // setup.p_fsdp) / n_glob.float())
    if setup.arch.moe.n_experts:
        scaled = scaled + MOE_AUX_COEF * aux / setup.aux_div
    # a table the batch does not read (``embeds`` in place of tokens) has
    # a zero gradient
    grads = torch.autograd.grad(scaled, params, allow_unused=True,
                                materialize_grads=True)
    return list(grads), loss_sum.detach(), n_glob, aux.detach()


def make_step(setup: TrainSetup, accum: int = 1, xent_chunk: int = 1024):
    """Returns ``step(state, batch, lr) -> (state, metrics)``.  ``batch``
    holds this rank's ``tokens`` and ``labels`` (numpy or tensors), and
    for the audio family its ``enc_embeds``; with
    ``accum > 1`` its rows split into ``accum`` equal microbatches.  The
    parameters and optimizer state are updated in place.  Under
    ``setup.overlap`` this is ``overlap.make_step(setup, "overlap")``."""
    if setup.overlap:
        return overlap_mod.make_step(setup, "overlap", accum, xent_chunk)
    if accum < 1:
        raise ValueError(f"accum={accum}")
    aggregator = agg_mod.GradAggregator(setup.agg_cfg)
    fsdp = setup.fsdp_axes
    replicated = [fsdp_dim(name) is None
                  for name, _ in setup.model.named_parameters()]
    update_fn = make_update_fn(setup, setup.layout)

    def norm_replicated_over_fsdp(grads):
        """The leaves FSDP does not shard never went through the
        reduce-scatter: their gradient is summed over the FSDP axes."""
        if not fsdp:
            return grads
        return [cp.psum(g, fsdp) if rep else g
                for g, rep in zip(grads, replicated)]

    def aggregate(grads, agg_states):
        if setup.agg_cfg.compressor == "none":
            axes = tuple(setup.agg_cfg.raw_axes) \
                + tuple(setup.agg_cfg.compress_axes)
            return [cp.mean_reduce(g, axes, setup.agg_cfg.comm)
                    for g in grads], agg_states
        if not (setup.agg_cfg.compress_axes or setup.agg_cfg.raw_axes):
            return list(grads), agg_states
        return aggregator.aggregate_bucketed(list(grads), agg_states,
                                             setup.layout)

    def step(state: dict, batch: dict, lr: float):
        batch = _to_device(batch, setup.device)
        params = state["params"]
        if accum > 1:
            for i, m in enumerate(microbatches(batch, accum)):
                g, l, n, a = local_grads(setup, m, params, xent_chunk)
                if i == 0:       # the fp32 sum starts at zero: exact
                    grads = [x.float() for x in g]
                    loss_sum, n_glob, aux = l, n, a
                    continue
                with torch.no_grad():
                    for acc, x in zip(grads, g):
                        acc.add_(x)
                loss_sum, n_glob, aux = loss_sum + l, n_glob + n, aux + a
                del g
            with torch.no_grad():
                for acc in grads:
                    acc.div_(accum)
            aux = aux / accum
        else:
            grads, loss_sum, n_glob, aux = local_grads(setup, batch, params,
                                                       xent_chunk)
        with torch.no_grad():
            grads = norm_replicated_over_fsdp(grads)
            if setup.rtob:
                # no gradient aggregation: the update's owner-aligned
                # reduce-scatter is the only gradient collective
                new_agg = state["agg"]
            else:
                grads, new_agg = aggregate(grads, state["agg"])
            params, new_opt, gnorm = update_fn(params, grads, state["opt"],
                                               lr)
            del grads
            metrics = train_metrics(setup, loss_sum, n_glob, gnorm, aux)
        new_state = {"step": state["step"] + 1, "params": params,
                     "opt": new_opt, "agg": new_agg}
        return new_state, metrics

    return step


# --------------------------------------------------------------------------
# local SGD
# --------------------------------------------------------------------------
def local_sgd_sync(setup: TrainSetup):
    """The pod-axis parameter mean of the ``--sync-every`` local-SGD mode
    (JAX ``train_step.local_sgd_sync``): ``sync(state) -> state`` with
    ``state["params"]`` replaced in place by their mean over ``pod``, or
    None when the pod axis is absent or of size 1.  As in the JAX package
    only the parameters are averaged, not ZeRO-1's fp32 master shard."""
    axes = tuple(a for a in ("pod",) if a in setup.dp_axes
                 and mesh_mod.axis_sizes()[a] > 1
                 and a not in setup.fsdp_axes)
    if not axes:
        return None

    @torch.no_grad()
    def sync(state: dict) -> dict:
        for p in state["params"]:
            p.copy_(cp.mean_reduce(p, axes, cp.CommPlan("allreduce")))
        return state
    return sync


def state_digest(obj) -> str:
    """SHA-256 of every tensor's bytes (and dtype, shape) and every scalar
    in a state: dicts in key order, lists and tuples in order.  Equal
    digests mean the same bits."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().contiguous().reshape(-1)
            h.update(f"{t.dtype}{tuple(x.shape)}".encode())
            h.update(t.view(torch.uint8).cpu().numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                h.update(repr(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[")
            for v in x:
                walk(v)
            h.update(b"]")
        else:
            h.update(repr(x).encode())
    walk(obj)
    return h.hexdigest()


def params_agree(params: Sequence[torch.Tensor], axes: Sequence[str]
                 ) -> bool:
    """Do the parameters hold the same bits on every rank along ``axes``?
    (their digests, gathered over the axes' group)"""
    mine = state_digest(list(params))
    got = [None] * mesh_mod.size(axes)
    dist.all_gather_object(got, mine, group=mesh_mod.group(axes))
    return all(d == mine for d in got)
