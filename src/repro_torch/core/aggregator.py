"""DP-axis gradient aggregation.  Counterpart of ``repro.core.aggregator``.

``aggregate_bucketed``: the gradient leaves -> 25 MB buckets, each bucket
compressed-aggregated over the compress axes (the PyTorch-DDP comm-hook
path the paper measures), after a raw mean over the raw axes if any.
The FSDP step runs it on the leaves' local shards (the JAX package's
train step does the same; its ``aggregate_shard`` is on no path).
Which collective moves each payload is the config's ``CommPlan``.
``from_plan`` is the JAX package's policy: ``compress_axes="pod"`` on a
``pod x data`` mesh means a raw mean over ``data``, then the compressor
over ``pod``; ``"all"`` compresses over both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core import bucketing
from repro_torch.core.compression import base as cbase
from repro_torch.parallel import commplan as cp


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    compressor: str = "none"          # compressor name for the compress axes
    compress_axes: Sequence[str] = ("data",)
    raw_axes: Sequence[str] = ()
    bucket_mb: float = 25
    compressor_kwargs: dict = dataclasses.field(default_factory=dict)
    comm: cp.CommPlan = dataclasses.field(default_factory=cp.CommPlan)

    def build(self) -> cbase.Compressor:
        return cbase.make(self.compressor, **self.compressor_kwargs)


class GradAggregator:
    """Owns the compressor; compressor state is passed in and returned."""

    def __init__(self, cfg: AggregatorConfig):
        self.cfg = cfg
        self.compressor = cfg.build()

    def aggregate_bucket_list(self, buckets, states):
        """THE bucket loop: each bucket through ``aggregate_one``.
        ``states`` may be empty for stateless compressors."""
        outs, news = [], []
        for i, b in enumerate(buckets):
            ob, ns = self.aggregate_one(b, states[i] if states else ())
            outs.append(ob)
            news.append(ns)
        return outs, tuple(news)

    def aggregate_bucketed(self, grads: Sequence[torch.Tensor], states,
                           layout: bucketing.BucketLayout):
        """grads: the local gradient leaves, in the layout's leaf order.
        One bucket at a time, each read out of the leaves (cast to the
        bucket dtype), aggregated, and written back into them in place (cast
        to each leaf's dtype), so at most one bucket exists beside the
        gradient.  Returns the aggregated leaves (``grads`` itself) and
        the new compressor states."""
        news, start = [], 0
        for i, n in enumerate(layout.sizes):
            bucket = bucketing.read_flat(
                grads, start, torch.empty(n, dtype=layout.dtype,
                                          device=grads[0].device),
                layout.dtype)
            out, ns = self.aggregate_one(bucket, states[i] if states else ())
            del bucket
            bucketing.write_flat(grads, start, out)
            news.append(ns)
            start += n
        return grads, tuple(news)

    def start_one(self, bucket: torch.Tensor) -> cp.PendingMean:
        """``aggregate_one`` of the ``none`` compressor with its collectives
        issued asynchronously (plans of ``commplan.ASYNC_KINDS``)."""
        axes = tuple(self.cfg.raw_axes) + tuple(self.cfg.compress_axes)
        return cp.mean_reduce_async(bucket, axes, self.cfg.comm)

    def aggregate_one(self, bucket: torch.Tensor, state: Any):
        """One bucket: encode -> reduce (``cfg.comm``) -> decode."""
        raw, comp = tuple(self.cfg.raw_axes), tuple(self.cfg.compress_axes)
        plan = self.cfg.comm
        if self.cfg.compressor == "none":
            return cp.mean_reduce(bucket, raw + comp, plan), state
        if raw:
            bucket = cp.mean_reduce(bucket, raw, cp.CommPlan("allreduce"))
        payload = self.compressor.encode_and_reduce(bucket, state, comp,
                                                    plan)
        return self.compressor.decode(payload, bucket, state)


def comm_from_plan(plan) -> cp.CommPlan:
    """``ParallelPlan.comm`` as a validated :class:`CommPlan`: legal for the
    compressor's associativity, and ``reduce_to_owner_broadcast`` only with
    an owner-sharded update."""
    comm = cp.CommPlan.parse(getattr(plan, "comm", "auto"))
    if comm.kind != "auto":
        comp = cbase.make(plan.compression, **cbase.plan_kwargs(plan))
        comm.validate(comp.associative)
    if comm.kind == "reduce_to_owner_broadcast" and not (
            getattr(plan, "zero1", False) and plan.compression == "none"):
        raise cp.CommPlanError(
            "comm='reduce_to_owner_broadcast' requires zero1=True and "
            "compression='none'")
    return comm


def from_plan(plan, multi_pod: bool = False) -> AggregatorConfig:
    """Translate an ``ArchConfig.plan`` into the aggregation policy (JAX
    ``core/aggregator.py`` ``from_plan``).  ``compress_axes="all"``: the
    compressor over ``("pod", "data")``, or ``("data",)`` on one pod.
    ``"pod"``: on several pods a raw mean over ``data`` and the compressor
    over ``pod``; on one pod a raw mean over ``data`` for ``none`` and the
    compressor over ``data`` otherwise."""
    kw = cbase.plan_kwargs(plan)
    if plan.compress_axes == "all":
        compress_axes: tuple[str, ...] = (("pod", "data") if multi_pod
                                          else ("data",))
        raw_axes: tuple[str, ...] = ()
    elif multi_pod:
        compress_axes, raw_axes = ("pod",), ("data",)
    elif plan.compression == "none":
        compress_axes, raw_axes = (), ("data",)
    else:
        compress_axes, raw_axes = ("data",), ()
    return AggregatorConfig(
        compressor=plan.compression,
        compress_axes=compress_axes,
        raw_axes=raw_axes,
        bucket_mb=plan.bucket_mb,
        compressor_kwargs=kw,
        comm=comm_from_plan(plan),
    )
