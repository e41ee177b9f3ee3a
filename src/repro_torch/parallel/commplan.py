"""CommPlan: the collective schedule as a first-class, declarative axis.

Counterpart of ``repro.parallel.commplan``.  The :class:`CommPlan` data
class, its parsing, legality checks and byte formulas are copied as they
are; see that module and docs/comm_api.md for the taxonomy.  The
executable reductions run over ``torch.distributed`` process groups, which
``repro_torch.launch.mesh`` maps from the mesh axis names (the public
vocabulary: ``pod``, ``data``).  On a group of one rank every collective
returns its input's value.

Every kind is ported: ``allreduce``, ``reduce_scatter_allgather``,
``gather_all``, ``hierarchical`` (the mean over the ``intra`` axes, then
over the rest) and ``reduce_to_owner_broadcast`` (ZeRO-1's plan: in the
step its gradient leg is ``owner_reduce_scatter`` and its broadcast leg
``gather_tensor``; as a plain mean it is the two-shot ring).

:func:`mean_reduce_async` issues the same means with ``async_op=True``, one
collective at a time: a gloo collective issued synchronously blocks the
host until it ends, which would hold back the issue of the next backward
stage in the overlapped step.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_mod

#: every concrete schedule (``auto`` is the resolve-from-payload sentinel).
KINDS = ("allreduce", "reduce_scatter_allgather",
         "reduce_to_owner_broadcast", "gather_all", "hierarchical")

#: kinds that mean-reduce and therefore require an associative payload.
ASSOCIATIVE_ONLY = ("allreduce", "reduce_scatter_allgather",
                    "reduce_to_owner_broadcast", "hierarchical")

#: kinds whose per-bucket collective can pipeline into the backward pass
#: (ring traffic with a complete result per bucket, paper Table 3):
#: ``gather_all`` needs every peer before any decode, and
#: ``reduce_to_owner_broadcast`` folds its exchange into the sharded
#: update, so neither overlaps.
OVERLAPPABLE = ("allreduce", "reduce_scatter_allgather", "hierarchical")


class CommPlanError(ValueError):
    """An illegal (plan, payload) combination — e.g. ring-reducing a
    non-associative payload."""


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """A frozen, JSON-round-trippable description of how a payload is
    aggregated across mesh axes.

    ``kind``   one of :data:`KINDS`, or ``"auto"`` (resolve from the
               payload's associativity — the historic dispatch).
    ``intra``  ``hierarchical`` only: the axes mean-reduced in the first
               (intra-pod) stage; the remaining reduction axes form the
               second (inter-pod) stage.  Axes named here but absent from
               a particular reduction are ignored, so one plan serves
               meshes with and without a pod axis.
    """
    kind: str = "auto"
    intra: tuple[str, ...] = ("data",)

    def __post_init__(self):
        if self.kind not in KINDS + ("auto",):
            raise CommPlanError(
                f"unknown comm plan kind {self.kind!r}; have "
                f"{KINDS + ('auto',)}")
        object.__setattr__(self, "intra", tuple(self.intra))

    # ---- legality: associativity constrains plan choice -----------------
    def legal_for(self, associative: bool) -> bool:
        return associative or self.kind not in ASSOCIATIVE_ONLY

    def validate(self, associative: bool) -> None:
        if not self.legal_for(associative):
            raise CommPlanError(
                f"comm plan {self.kind!r} mean-reduces its payload, but "
                f"the payload is non-associative (paper Table 3): only "
                f"'gather_all' (or 'auto') can move it")

    def validate_axes(self, axes: Sequence[str]) -> None:
        """Hierarchical plans must split a non-empty reduction into a
        non-empty INNER stage: ``intra`` naming no axis of the actual
        reduction means the whole mean would silently run as a
        single-stage ring over the slow tier — on a real two-tier pod
        mesh that is a misconfigured plan, not a degenerate split
        (``tests/test_multiproc.py`` pins the error).  Intra axes absent
        from the reduction are still ignored (one plan serves meshes
        with and without a pod axis) as long as at least one is present.
        """
        if self.kind != "hierarchical":
            return
        axes = tuple(axes)
        if not axes:
            return
        if not any(a in self.intra for a in axes):
            raise CommPlanError(
                f"hierarchical comm plan intra={self.intra} names no axis "
                f"of the reduction over {axes}: the intra (fast-tier) "
                f"stage would be empty and the whole payload would ride "
                f"the slow tier — name at least one reduction axis, e.g. "
                f"comm='hierarchical:{axes[-1]}'")

    def resolve(self, associative: bool) -> "CommPlan":
        """Concrete plan for a payload: ``auto`` resolves to the historic
        dispatch; everything else validates and returns itself."""
        if self.kind == "auto":
            return dataclasses.replace(
                self, kind="allreduce" if associative else "gather_all")
        self.validate(associative)
        return self

    @property
    def gathers(self) -> bool:
        """Does the reduced payload carry a leading peer axis of size p
        (the ``gather_all`` wire shape)?"""
        return self.kind == "gather_all"

    # ---- JSON round trip ------------------------------------------------
    def to_json(self) -> dict:
        return dict(kind=self.kind, intra=list(self.intra))

    @classmethod
    def from_json(cls, d: dict) -> "CommPlan":
        return cls(kind=d.get("kind", "auto"),
                   intra=tuple(d.get("intra", ("data",))))

    @classmethod
    def parse(cls, s: "str | CommPlan | None") -> "CommPlan":
        """``"hierarchical"`` or ``"hierarchical:pod+data"`` (intra axes
        ``+``-joined after the colon) -> CommPlan.  None -> auto.  An
        ``:intra`` suffix on any other kind is rejected (it would be
        silently ignored — and two spellings of one plan must not hash
        to two experiment cells)."""
        if s is None:
            return cls("auto")
        if isinstance(s, CommPlan):
            return s
        kind, _, intra = str(s).partition(":")
        if intra:
            if kind != "hierarchical":
                raise CommPlanError(
                    f"comm plan {s!r}: only 'hierarchical' takes an "
                    f":intra+axes suffix")
            return cls(kind=kind, intra=tuple(intra.split("+")))
        return cls(kind=kind)

    def spec_str(self) -> str:
        """Inverse of :meth:`parse` (the ``ExperimentSpec.comm`` form)."""
        if self.kind == "hierarchical" and self.intra != ("data",):
            return f"{self.kind}:{'+'.join(self.intra)}"
        return self.kind

    # ---- analytic wire accounting (the byte formulas the perf model and
    # ---- the bench anchors read; time lives in perfmodel.costs) ---------
    def wire_bytes(self, n: float, p: int, congestion: float = 1.0,
                   p_intra: int = 1) -> float:
        """Effective bytes exchanged per device to aggregate an ``n``-byte
        payload over ``p`` workers — the β-term bytes of the matching
        ``perfmodel.costs`` collective (congestion inflates the gather's
        effective bytes; ring traffic is congestion-free).

        ``hierarchical`` splits p into ``p_intra`` × ``p / p_intra``.
        """
        if p <= 1:
            return 0.0
        kind = self.kind
        if kind == "auto" or kind == "allreduce" \
                or kind == "reduce_scatter_allgather":
            return 2.0 * n * (p - 1) / p
        if kind == "reduce_to_owner_broadcast":
            # the gradient leg only (one ring reduce-scatter to owners);
            # the broadcast leg moves the owner's PRODUCT (under ZeRO-1:
            # the updated params — costed by zero1's param term, not here)
            return n * (p - 1) / p
        if kind == "gather_all":
            return congestion * n * (p - 1)
        if kind == "hierarchical":
            p_i = max(1, min(p_intra, p))
            p_o = p // p_i
            return (2.0 * n * (p_i - 1) / p_i
                    + 2.0 * n * (p_o - 1) / p_o)
        raise CommPlanError(kind)


# --------------------------------------------------------------------------
# executable reductions (torch.distributed over the mesh's process groups)
# --------------------------------------------------------------------------
# PyTorch 2.13 renamed the single-tensor collectives; older builds have
# only the old names.
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def axes_p(axes: Sequence[str]) -> int:
    """Total size of the named reduction axes."""
    return mesh_mod.size(axes)


def psum(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Sum of ``t`` over ``axes`` (``jax.lax.psum``); a new tensor."""
    out = t.clone()
    if tuple(axes):
        dist.all_reduce(out, group=mesh_mod.group(axes))
    return out


def gather_tensor(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``all_gather`` normalized to a leading peer axis ``(p, *shape)`` —
    the non-associative wire shape (and ZeRO-1's param broadcast leg)."""
    p = axes_p(axes)
    flat = t.reshape(-1).contiguous()
    out = torch.empty(p * flat.numel(), dtype=t.dtype, device=t.device)
    _all_gather_single(out, flat, group=mesh_mod.group(axes))
    return out.reshape((p,) + tuple(t.shape))


def _rs_ag_mean(t: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
    """Two-shot ring mean: pad-to-p, reduce-scatter (each rank holds the
    summed 1/p tile), all-gather, unpad, divide."""
    p = axes_p(axes)
    group = mesh_mod.group(axes)
    flat = t.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % p
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    flat = flat.contiguous()
    shard = torch.empty(flat.shape[0] // p, dtype=t.dtype, device=t.device)
    _reduce_scatter_single(shard, flat, group=group)
    full = torch.empty_like(flat)
    _all_gather_single(full, shard, group=group)
    return (full[:n] / p).reshape(t.shape).to(t.dtype)


def mean_reduce(t: torch.Tensor, axes: Sequence[str], plan: CommPlan,
                ) -> torch.Tensor:
    """The mean of ``t`` over ``axes``, moved by ``plan``'s collective.
    Every kind returns the full mean on every rank (``gather_all``
    gathers then averages the peer rows: same value, another summation
    order).  ``hierarchical`` waits for the slice that brings its pod
    axis."""
    axes = tuple(axes)
    if not axes:
        return t
    plan.validate_axes(axes)
    kind = plan.resolve(associative=True).kind
    if kind == "allreduce":
        return psum(t, axes) / axes_p(axes)
    if kind in ("reduce_scatter_allgather", "reduce_to_owner_broadcast"):
        # without a sharded consumer, reduce-to-owner + broadcast of the
        # reduced bucket IS the two-shot ring
        return _rs_ag_mean(t, axes)
    if kind == "hierarchical":
        return _hier_mean(t, axes, plan.intra)
    if kind == "gather_all":
        g = gather_tensor(t, axes)
        return (g.sum(dim=0) / axes_p(axes)).to(t.dtype)
    raise CommPlanError(kind)


def _hier_split(axes: tuple[str, ...], intra: Sequence[str]
                ) -> list[tuple[str, ...]]:
    """The stages of a hierarchical mean: the intra axes present, then the
    rest; a degenerate split is one stage."""
    inner = tuple(a for a in axes if a in intra)
    outer = tuple(a for a in axes if a not in intra)
    return [s for s in (inner, outer) if s]


def _hier_mean(t: torch.Tensor, axes: tuple[str, ...],
               intra: Sequence[str]) -> torch.Tensor:
    """Mean over the intra axes (the fast tier) then over the rest (the
    slow tier).  Equal group sizes make the mean of means the global
    mean, in another summation order than one all-reduce."""
    for stage in _hier_split(axes, intra):
        t = psum(t, stage) / axes_p(stage)
    return t


class PendingMean:
    """A mean in flight (:func:`mean_reduce_async`): a chain of
    collectives, each issued with ``async_op=True`` once the one before it
    has finished.  :meth:`poll` moves the chain on without blocking the
    host; :meth:`wait` finishes it.  Both make the caller's current stream
    wait for what finished, so call them on the stream that issued the
    chain."""

    def __init__(self, t: torch.Tensor, stages):
        self._t = t
        self._stages = list(stages)
        self._work = None
        self._finish = None
        self._start()

    def _start(self) -> None:
        self._work = None
        if self._stages:
            self._work, self._finish = self._stages.pop(0)(self._t)

    def _advance(self) -> None:
        self._work.wait()
        self._t = self._finish()
        self._start()

    def poll(self) -> bool:
        """Issue every stage whose predecessor has finished; True when the
        mean is complete."""
        while self._work is not None and self._work.is_completed():
            self._advance()
        return self._work is None

    def wait(self) -> torch.Tensor:
        while self._work is not None:
            self._advance()
        return self._t


def _mean_stage(axes: tuple[str, ...]):
    """One stage of an asynchronous mean: the sum over ``axes`` (one
    all-reduce of a copy), divided by their size once it has arrived; the
    operations of :func:`psum` ``/`` :func:`axes_p`."""
    def start(t: torch.Tensor):
        out = t.clone()
        p = axes_p(axes)
        work = dist.all_reduce(out, group=mesh_mod.group(axes),
                               async_op=True)
        return work, lambda: out / p
    return start


#: plans whose mean :func:`mean_reduce_async` issues: chains of all-reduces
#: in which no group is used twice, so a chain moved on whenever its
#: collective happens to finish still issues each group's collectives in
#: the same order on every rank (``reduce_scatter_allgather`` runs both of
#: its collectives on one group, and stays synchronous).
ASYNC_KINDS = ("allreduce", "hierarchical")


def mean_reduce_async(t: torch.Tensor, axes: Sequence[str], plan: CommPlan,
                      ) -> PendingMean:
    """:func:`mean_reduce` for the plans of :data:`ASYNC_KINDS`, issued
    asynchronously: the same collectives on the same values, hence the
    same bits."""
    axes = tuple(axes)
    if not axes:
        return PendingMean(t, [])
    plan.validate_axes(axes)
    kind = plan.resolve(associative=True).kind
    if kind == "allreduce":
        return PendingMean(t, [_mean_stage(axes)])
    if kind == "hierarchical":
        return PendingMean(t, [_mean_stage(s)
                               for s in _hier_split(axes, plan.intra)])
    raise CommPlanError(f"comm plan {kind!r} has no asynchronous mean")


def owner_reduce_scatter(flat_tiles: torch.Tensor, axes: Sequence[str],
                         ) -> torch.Tensor:
    """Reduce-to-owner over an owner-aligned ``(p·cap,)`` layout: tile
    ``r`` holds the elements rank ``r`` owns, so one reduce-scatter
    delivers each owner the SUM of its shard, ``(cap,)``.  The
    ``reduce_to_owner_broadcast`` gradient leg."""
    p = axes_p(axes)
    flat = flat_tiles.contiguous()
    if flat.ndim != 1 or flat.shape[0] % p:
        raise ValueError(f"tiles of shape {tuple(flat.shape)} do not split "
                         f"into {p} owner tiles")
    out = torch.empty(flat.shape[0] // p, dtype=flat.dtype,
                      device=flat.device)
    _reduce_scatter_single(out, flat, group=mesh_mod.group(axes))
    return out
