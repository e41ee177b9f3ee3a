"""The classic DDP train step: loss -> backward -> bucketed gradient
aggregation (the paper's subject) -> AdamW.  Counterpart of the ``ddp``
path of ``repro.train.train_step`` with ``zero1=False``,
``overlap=False`` and ``accum=1``.

Each rank holds the full fp32 parameters and its own slice of the global
batch.  The gradient leaves are raveled into 25 MB buckets and each bucket
is aggregated by the configured compressor over the DP axes.  Loss scaling
is the JAX package's: ``loss_sum * p_dp / n_tokens_global``, so the mean
over the ranks of the local gradients is the global-mean gradient.

Every compressor of the JAX registry runs here, and ``ef:<name>`` for
all but PowerSGD.  ``build`` raises ``NotImplementedError`` on what later
slices port: FSDP, ZeRO-1 (the ``tinyllama-1.1b`` default: pass
``zero1=False``), the overlapped schedule, accumulation, the adaptive
controller, bf16 parameters, other optimizers and comm plans, and
``compress_axes`` other than ``"pod"``.
Like the JAX ``build``, it drops reduction axes of size 1: on one rank the
compressor is not run unless the caller points ``agg_cfg`` back at the
``data`` axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import aggregator as agg_mod
from repro_torch.core import bucketing
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Model
from repro_torch.parallel import commplan as cp
from repro_torch.train import optimizer as opt_mod

#: offset of the compressor-state seed from the parameter seed.
AGG_SEED_OFFSET = 7


@dataclasses.dataclass
class TrainSetup:
    """Everything needed to init and run DDP training of one arch."""
    arch: ArchConfig
    model: Model
    device: torch.device
    dp_axes: tuple[str, ...]
    agg_cfg: agg_mod.AggregatorConfig
    opt_cfg: opt_mod.OptConfig
    layout: bucketing.BucketLayout

    @property
    def comm(self) -> cp.CommPlan:
        return self.agg_cfg.comm

    @property
    def p_dp(self) -> int:
        return cp.axes_p(self.dp_axes)


def _check_ported(plan) -> None:
    todo = []
    if plan.dp_mode != "ddp":
        todo.append(f"dp_mode={plan.dp_mode!r}")
    for field in ("zero1", "overlap", "adaptive"):
        if getattr(plan, field):
            todo.append(f"{field}=True")
    if plan.param_dtype != "float32":
        todo.append(f"param_dtype={plan.param_dtype!r}")
    if plan.optimizer != "adamw":
        todo.append(f"optimizer={plan.optimizer!r}")
    if plan.compress_axes != "pod":         # the port has no pod axis yet
        todo.append(f"compress_axes={plan.compress_axes!r}")
    kind = cp.CommPlan.parse(plan.comm).kind
    if kind in ("hierarchical", "reduce_to_owner_broadcast"):
        todo.append(f"comm={plan.comm!r}")
    if todo:
        raise NotImplementedError(
            f"not ported yet: {', '.join(todo)} (this port runs the classic "
            f"DDP step with zero1=False)")


def build(arch: ArchConfig, device: "str | torch.device | None" = None,
          opt_cfg: Optional[opt_mod.OptConfig] = None,
          **plan_overrides) -> TrainSetup:
    """Set up DDP training of ``arch`` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``).  Joins a process group if this process has
    none (see ``launch.mesh.init_world``)."""
    plan = dataclasses.replace(arch.plan, **plan_overrides) \
        if plan_overrides else arch.plan
    arch = dataclasses.replace(arch, plan=plan)
    _check_ported(plan)
    dev = mesh_mod.resolve_device(device)
    mesh_mod.init_world(dev)
    sizes = mesh_mod.axis_sizes()
    dp_axes = ("data",)
    agg_cfg = agg_mod.from_plan(plan)
    agg_cfg = dataclasses.replace(
        agg_cfg,
        compress_axes=tuple(a for a in agg_cfg.compress_axes
                            if sizes.get(a, 1) > 1),
        raw_axes=tuple(a for a in agg_cfg.raw_axes if sizes.get(a, 1) > 1))
    agg_cfg.comm.validate_axes(agg_cfg.raw_axes + agg_cfg.compress_axes)
    model = Model(arch, device=dev)
    layout = bucketing.layout_for(list(model.parameters()), plan.bucket_mb)
    return TrainSetup(arch=arch, model=model, device=dev,
                      dp_axes=dp_axes, agg_cfg=agg_cfg,
                      opt_cfg=opt_cfg or opt_mod.OptConfig(name=plan.optimizer),
                      layout=layout)


def _compressed(setup: TrainSetup) -> bool:
    return setup.agg_cfg.compressor != "none" \
        and bool(setup.agg_cfg.compress_axes)


def init_state(setup: TrainSetup, seed: int = 0) -> dict:
    """Fresh parameters from ``seed`` and zero optimizer and compressor
    state.  PowerSGD's warm starts and the stochastic compressors' keys
    are drawn bucket by bucket from one generator of a second seed, so
    every bucket has its own and every rank the same (QSGD and TernGrad
    fold the rank into their draws; RandomK needs the same indices on
    every rank)."""
    dev = setup.device
    setup.model.init_params(torch.Generator(device=dev).manual_seed(seed))
    params = list(setup.model.parameters())
    opt = opt_mod.make(setup.opt_cfg.name, setup.opt_cfg)
    state = {"step": 0, "params": params, "opt": opt.init(params), "agg": ()}
    if _compressed(setup):
        gen = torch.Generator(device=dev).manual_seed(seed + AGG_SEED_OFFSET)
        comp = setup.agg_cfg.build()
        state["agg"] = tuple(comp.init_state(n, gen, dev)
                             for n in setup.layout.sizes)
    return state


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=device).long()
            for k, v in batch.items()}


def make_step(setup: TrainSetup, accum: int = 1, xent_chunk: int = 1024):
    """Returns ``step(state, batch, lr) -> (state, metrics)``.  ``batch``
    holds this rank's ``tokens`` and ``labels`` (numpy or tensors).  The
    parameters and optimizer moments are updated in place."""
    if accum != 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    model = setup.model
    aggregator = agg_mod.GradAggregator(setup.agg_cfg)
    opt = opt_mod.make(setup.opt_cfg.name, setup.opt_cfg)
    dp = setup.dp_axes
    p_dp = setup.p_dp

    def aggregate(grads, agg_states):
        if setup.agg_cfg.compressor == "none":
            axes = tuple(setup.agg_cfg.raw_axes) \
                + tuple(setup.agg_cfg.compress_axes)
            return [cp.mean_reduce(g, axes, setup.agg_cfg.comm)
                    for g in grads], agg_states
        if not (setup.agg_cfg.compress_axes or setup.agg_cfg.raw_axes):
            return list(grads), agg_states
        return aggregator.aggregate_bucketed(grads, agg_states, setup.layout)

    def step(state: dict, batch: dict, lr: float):
        batch = _to_device(batch, setup.device)
        params = state["params"]
        loss_sum, ntok = model.loss(batch, xent_chunk)
        n_glob = cp.psum(ntok, dp)
        scaled = loss_sum * (p_dp / n_glob.float())
        grads = torch.autograd.grad(scaled, params)
        with torch.no_grad():
            grads, new_agg = aggregate(grads, state["agg"])
            params, new_opt, om = opt.update(grads, state["opt"], params, lr)
            loss_g = cp.psum(loss_sum.detach(), dp)
            metrics = {"loss": loss_g / torch.clamp(n_glob.float(), min=1.0),
                       "tokens": n_glob,
                       "grad_norm": om["grad_norm"]}
        new_state = {"step": state["step"] + 1, "params": params,
                     "opt": new_opt, "agg": new_agg}
        return new_state, metrics

    return step
