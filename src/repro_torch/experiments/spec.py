"""Declarative experiment specs + grid builders.  Counterpart of
``repro.experiments.spec``: the same fields, JSON and hashes, so a store
written by either package loads in the other.

The paper's headline result is a *matrix* — "only 6 cases out of more than
200 setups" — so the setup grid itself is first-class data here.  An
``ExperimentSpec`` pins one setup: workload × hardware × worker count ×
compression policy × axes policy.  It is frozen, hashable, and JSON
round-trippable (``to_json``/``from_json``/``spec_hash``), which is what
lets the ``ResultStore`` resume sweeps by content hash and lets the bench
trajectory (``BENCH_*.json``) reference setups stably across PRs.

Unset optional fields (``None`` / ``0`` sentinels) resolve against the
calibration registry inside the backend; explicit values always win, so a
spec can either *name* a paper workload ("resnet101") or carry its exact
parameters inline.  All quantities are SI base units (bytes, seconds,
bytes/s) so a spec round-trips through the backend bit-exactly.

``Grid`` expands declarative cross-products of specs; ``Grid.paper_matrix``
enumerates the paper's ≥200-setup evaluation matrix as data.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Any, Iterator, Optional, Sequence

#: methods evaluated by the paper (Table 2) — resolvable by name alone.
PAPER_METHODS = ("powersgd-r4", "powersgd-r8", "powersgd-r16",
                 "mstopk-0.01", "mstopk-0.001", "signsgd")
#: the paper's §3 workloads — resolvable by name alone.
PAPER_WORKLOADS = ("resnet50", "resnet101", "bert-base")
#: the paper's data-center worker-count axis (4 .. 128 GPUs).
PAPER_WORKER_COUNTS = (4, 8, 12, 16, 24, 32, 48, 64, 80, 96, 112, 128)

BASELINE_METHODS = ("syncsgd", "none")


def _freeze(v):
    """Sequences -> nested tuples, so override values stay hashable and
    JSON lists round-trip back to the original spec."""
    return (tuple(_freeze(x) for x in v)
            if isinstance(v, (list, tuple)) else v)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One setup of the sweep matrix.  Frozen, hashable, JSON-stable.

    Identity fields (always set):
      ``workload``  calibration workload name ("resnet101"), arch name
                    ("tinyllama-1.1b") for dry-run cells, or a free label
                    when the inline fields below are given.
      ``method``    "syncsgd"/"none" = the optimized baseline; a paper
                    Table-2 method name; or "live:<compressor>[:k=v...]"
                    for this repo's registered compressors.
      ``workers``   data-parallel worker count p.
      ``batch``     per-worker batch (weak scaling; 64 = paper default).
      ``hardware``  hardware preset name ("paper", "v100-ec2-10gbps",
                    "cpu-host", "h100") or "custom" (inline overrides carry
                    it).
      ``compress_axes``  which DP mesh axes the compressor runs on
                    ("pod" = the paper's compress-the-slow-link policy).
      ``kind``      "analytic" | "measured" | "dryrun" | "train" — which
                    backend family can evaluate it ("dryrun" is the JAX
                    package's; this package's measured backend returns
                    an error for it) ("train" = the
                    measured serial-vs-overlapped DDP step comparison,
                    run on a forced multi-device host mesh).
      ``overlap``   the baseline-overlap knob (repro_torch.train.overlap).
                    ``None`` = the paper's optimized overlapped baseline
                    (historic behaviour); ``False`` = the serial
                    no-overlap strawman (analytic: Fig-2 serial time;
                    train: reported either way).
      ``zero1``     shard optimizer state owner-rank-per-bucket over DP
                    (analytic: adds the post-update parameter all-gather
                    to every leg; train: runs the measured schedules
                    under ``plan.zero1=True``).  Wire-format rev 3.
      ``accum``     gradient-accumulation microbatches per step (analytic:
                    multiplies the compute leg, amortizing the unchanged
                    per-step comm; train: per-microbatch segmented
                    backward with flush-on-final-microbatch).  Rev 3.
      ``comm``      the collective schedule (a ``CommPlan`` kind string,
                    docs/comm_api.md): "auto" (resolve from payload
                    associativity — the historic dispatch) | "allreduce" |
                    "reduce_scatter_allgather" |
                    "reduce_to_owner_broadcast" | "gather_all" |
                    "hierarchical[:intra+axes]".  Analytic: baseline and
                    method legs priced per plan
                    (``pm.sync_sgd_plan_time`` /
                    ``pm.compressed_plan_time``, legality enforced);
                    train: ``ParallelPlan.comm`` override on the measured
                    step.  Wire-format rev 4.
      ``scheme``    "static" = the cell pins one method (historic
                    behaviour); "adaptive" = the cell is the adaptive
                    controller (``repro_torch.adaptive``): per setup it picks
                    the fastest of {overlapped syncSGD} ∪ the paper's
                    Table-2 schemes from the perf model and reports the
                    pick (``method="adaptive"`` implies it).  Rev 5.
      ``error_feedback``  wrap a ``live:<name>`` method's compressor in
                    the ``ef:`` residual accumulator
                    (``repro_torch.adaptive.feedback``); descriptive for named
                    paper methods, which already carry EF where the
                    original scheme does.  Wire-format rev 5.
      ``procs``     OS processes of the measured pod (0 = in-process, the
                    historic single-process backends).  ``procs >= 2``
                    makes a ``kind="train"`` cell a real
                    ``torch.distributed`` pod: the ``MultiProcessBackend``
                    launches ``workers`` rank processes, ``workers //
                    procs`` per pod, on a two-tier (pod × data) mesh —
                    the pod axis is the measured slow ("DCN") tier.  Wire-format
                    rev 6.

    Inline overrides (None/0 = resolve from the calibration registry):
      workload: ``model_bytes``, ``t_comp_s``;
      hardware: ``net_bw`` (bytes/s), ``alpha`` (s), ``congestion``,
                ``peak_flops``;
      method:   ``t_encode_decode_s``, ``payload_bytes`` (per collective
                round), ``associative``.

    Measured/dry-run extras: ``n_elements`` (bucket size for live timing),
    ``shape``/``mesh``/``variant``/``overrides`` (dry-run cell coordinates
    and ParallelPlan overrides).
    """
    workload: str
    method: str = "syncsgd"
    workers: int = 1
    batch: int = 64
    hardware: str = "paper"
    compress_axes: str = "pod"
    kind: str = "analytic"
    overlap: Optional[bool] = None
    zero1: bool = False
    accum: int = 1
    comm: str = "auto"
    scheme: str = "static"
    error_feedback: bool = False
    procs: int = 0
    # -- inline workload parameters (0.0 = resolve by name) --
    model_bytes: float = 0.0
    t_comp_s: float = 0.0
    # -- inline hardware overrides (None = preset default) --
    net_bw: Optional[float] = None
    alpha: Optional[float] = None
    congestion: Optional[float] = None
    peak_flops: Optional[float] = None
    # -- inline compression-method overrides (None = resolve by name) --
    t_encode_decode_s: Optional[float] = None
    payload_bytes: Optional[tuple[float, ...]] = None
    associative: Optional[bool] = None
    # -- measured / dry-run extras --
    n_elements: int = 0
    shape: str = ""
    mesh: str = ""
    variant: str = ""
    overrides: tuple[tuple[str, Any], ...] = ()

    def __post_init__(self):
        # normalize list-y fields to tuples (recursively for override
        # values) so specs stay hashable and JSON-round-trippable even
        # when built from JSON or keyword lists
        if self.payload_bytes is not None:
            object.__setattr__(self, "payload_bytes",
                               tuple(float(b) for b in self.payload_bytes))
        object.__setattr__(self, "overrides",
                           tuple((str(k), _freeze(v))
                                 for k, v in self.overrides))

    @property
    def is_baseline(self) -> bool:
        return self.method in BASELINE_METHODS

    @property
    def is_adaptive(self) -> bool:
        """Adaptive-controller cell (``repro_torch.adaptive``): the method is
        chosen per setup instead of pinned by the spec."""
        return self.scheme == "adaptive" or self.method == "adaptive"

    # ---- JSON round-trip ------------------------------------------------
    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["payload_bytes"] = (None if self.payload_bytes is None
                              else list(self.payload_bytes))
        d["overrides"] = [list(kv) for kv in self.overrides]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        if d.get("payload_bytes") is not None:
            d["payload_bytes"] = tuple(d["payload_bytes"])
        d["overrides"] = tuple(tuple(kv) for kv in d.get("overrides", ()))
        return cls(**d)

    def spec_hash(self) -> str:
        """Stable content hash — the resume key of the ``ResultStore``."""
        blob = json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def label(self) -> str:
        """Short human-readable identity for logs and BENCH rows."""
        parts = [self.workload, self.method, f"p{self.workers}",
                 f"b{self.batch}"]
        if self.procs:
            parts.append(f"procs{self.procs}")
        if self.variant:
            parts.append(self.variant)
        return "/".join(parts)


# ---- field builders: lift live perf-model objects into spec fields ---------
def workload_fields(w) -> dict:
    """Inline fields for a ``perfmodel.model.Workload`` (exact units)."""
    return dict(workload=w.name, model_bytes=float(w.model_bytes),
                t_comp_s=float(w.t_comp))


def hardware_fields(hw) -> dict:
    """Inline fields for a ``perfmodel.hardware.Hardware`` — carries every
    parameter the analytic model reads (including ``peak_flops``, used to
    estimate live-method encode times), so "custom" is fully determined."""
    return dict(hardware="custom", net_bw=float(hw.net_bw),
                alpha=float(hw.alpha),
                congestion=float(hw.allgather_congestion),
                peak_flops=float(hw.peak_flops))


def method_fields(cspec) -> dict:
    """Inline fields for a ``perfmodel.model.CompressionSpec``."""
    return dict(method=cspec.name,
                t_encode_decode_s=float(cspec.t_encode_decode),
                payload_bytes=tuple(float(b) for b in cspec.payload_bytes),
                associative=bool(cspec.associative))


# ---- Grid ------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Grid:
    """A declarative cross-product of ``ExperimentSpec``s.

    ``axes`` is an ordered tuple of ``(name, values)``; each value is
    either a scalar (assigned to the spec field ``name``) or a dict of
    spec fields applied together (a *compound* axis — e.g. a batch sweep
    that rescales ``t_comp_s`` and the encode time in lockstep).  The last
    axis varies fastest, like ``itertools.product``.
    """
    base: ExperimentSpec
    axes: tuple[tuple[str, tuple], ...] = ()

    @classmethod
    def over(cls, base: ExperimentSpec, **axes: Sequence) -> "Grid":
        return cls(base, tuple((name, tuple(vals))
                               for name, vals in axes.items()))

    def specs(self) -> list[ExperimentSpec]:
        names = [name for name, _ in self.axes]
        out = []
        for combo in itertools.product(*(vals for _, vals in self.axes)):
            fields: dict = {}
            for name, val in zip(names, combo):
                fields.update(val if isinstance(val, dict) else {name: val})
            out.append(dataclasses.replace(self.base, **fields))
        return out

    def __len__(self) -> int:
        n = 1
        for _, vals in self.axes:
            n *= len(vals)
        return n

    def __iter__(self) -> Iterator[ExperimentSpec]:
        return iter(self.specs())

    # ---- the paper's evaluation matrix, as data -------------------------
    @classmethod
    def paper_matrix(cls,
                     workloads: Sequence[str] = PAPER_WORKLOADS,
                     methods: Sequence[str] = PAPER_METHODS,
                     workers: Sequence[int] = PAPER_WORKER_COUNTS,
                     batch: int = 64,
                     comm: Sequence[str] = ("auto",)) -> "Grid":
        """The paper's ≥200-setup matrix (abstract: "more than 200
        different setups ... only in 6 cases" does compression win): every
        studied model × every Table-2 scheme × the data-center worker-count
        axis, at the typical batch size and the 10 Gb/s paper cluster.
        3 × 6 × 12 = 216 setups, each compared against optimized syncSGD.

        ``comm`` expands the matrix across collective schedules
        (docs/comm_api.md) — the scenario axis the paper only models
        analytically: e.g. ``comm=("auto", "gather_all")`` scores every
        cell against BOTH the ring baseline and a syncSGD that pays
        gather-based costs.  The default keeps the historic 216-cell
        matrix (and its hashes) unchanged.
        """
        base = ExperimentSpec(workload=workloads[0], hardware="paper",
                              batch=batch)
        axes: dict = dict(workload=list(workloads), method=list(methods),
                          workers=list(workers))
        if tuple(comm) != ("auto",):
            axes["comm"] = list(comm)
        return cls.over(base, **axes)

    @classmethod
    def adaptive_matrix(cls,
                        workloads: Sequence[str] = PAPER_WORKLOADS,
                        workers: Sequence[int] = PAPER_WORKER_COUNTS,
                        batch: int = 64) -> "Grid":
        """One adaptive-controller cell per (workload × workers) setup of
        the paper matrix: each cell picks the fastest of {overlapped
        syncSGD} ∪ the Table-2 schemes (``repro_torch.adaptive.policy``), so
        its ``headline()`` row wins-or-ties the best static scheme by
        construction — the paper's thesis as a benchmark anchor."""
        base = ExperimentSpec(workload=workloads[0], hardware="paper",
                              batch=batch, method="adaptive",
                              scheme="adaptive")
        return cls.over(base, workload=list(workloads),
                        workers=list(workers))
