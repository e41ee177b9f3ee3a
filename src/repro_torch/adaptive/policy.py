"""The adaptive decision rule: compress only when the model says it wins.
Counterpart of ``repro.adaptive.policy``.

Pure functions over the paper's performance model — no torch, no state.
Given a workload, a worker count and a hardware point, :func:`decide`
prices every candidate ``{scheme, rank/k, CommPlan}`` with
``pm.compressed_plan_time`` and the overlapped syncSGD baseline with
``pm.sync_sgd_plan_time``, and picks the argmin — falling back to the
baseline whenever no candidate is predicted to win.  By construction the
adaptive choice wins-or-ties the best static scheme *and* the baseline in
every setup: that is the constructive restatement of the paper's headline
("compression rarely wins — so only compress where it does").

The runtime half (measured feedback, hysteresis, launch-time plan
resolution) is ``adaptive.controller``; the experiment matrix consumes
:func:`decide` through the analytic backend's ``method="adaptive"``
cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.perfmodel import model as pm
from repro_torch.core.perfmodel.hardware import Hardware


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One static scheme the controller may pick: a perf-model
    ``CompressionSpec`` plus the CommPlan kind its payloads ride."""
    method: str
    spec: pm.CompressionSpec
    comm: str = "auto"


@dataclasses.dataclass(frozen=True)
class Decision:
    """The controller's verdict for one (workload, p, hw) cell."""
    scheme: str            # "syncsgd" or the winning candidate's method
    comm: str              # the CommPlan kind the choice rides
    t_pred: float          # predicted step time of the choice (s)
    t_base: float          # overlapped syncSGD baseline time (s)
    win: bool              # choice strictly beats the baseline

    @property
    def is_baseline(self) -> bool:
        return self.scheme == "syncsgd"


def paper_candidates(w: pm.Workload,
                     comm: str = "auto") -> list[Candidate]:
    """The paper's Table-2 methods as the default candidate pool, priced
    from the calibration tables for this workload."""
    from repro_torch.core.perfmodel import calibration as cal
    from repro_torch.experiments.spec import PAPER_METHODS
    return [Candidate(m, cal.paper_spec(m, w), comm) for m in PAPER_METHODS]


def decide(w: pm.Workload, p: int, hw: Hardware,
           candidates: Sequence[Candidate],
           margin: float = 0.0,
           t_extra: float = 0.0,
           comm_base: str = "auto") -> Decision:
    """Pick the fastest of {overlapped syncSGD} ∪ candidates.

    ``margin`` demands a relative predicted win before leaving the
    baseline (the static half of the hysteresis band — a candidate must
    be ``> margin`` faster than syncSGD to be chosen at all).  ``t_extra``
    is a per-leg additive term landing on every choice (ZeRO-1's
    post-update param exchange).  Illegal (payload, plan) combinations
    are skipped, exactly as the runtime would reject them.
    """
    from repro_torch.parallel.commplan import CommPlanError
    t_base = pm.sync_sgd_plan_time(w, p, hw, comm_base) + t_extra
    best: Optional[Candidate] = None
    best_t = float("inf")
    for c in candidates:
        try:
            t = pm.compressed_plan_time(w, p, hw, c.spec, c.comm) + t_extra
        except CommPlanError:
            continue
        if t < best_t:
            best, best_t = c, t
    if best is not None and best_t < t_base * (1.0 - margin):
        return Decision(scheme=best.method, comm=best.comm, t_pred=best_t,
                        t_base=t_base, win=True)
    return Decision(scheme="syncsgd", comm=comm_base, t_pred=t_base,
                    t_base=t_base, win=False)


def bucket_workloads(w: pm.Workload,
                     bucket_bytes: Sequence[float]) -> list[pm.Workload]:
    """Split a workload into per-bucket mini-workloads: each bucket
    carries its byte share of the gradient and the same share of the
    backward compute (the slice of backward that produces it)."""
    total = max(sum(bucket_bytes), 1e-12)
    return [dataclasses.replace(w, name=f"{w.name}/bucket{i}",
                                model_bytes=float(b),
                                t_comp=w.t_comp * float(b) / total)
            for i, b in enumerate(bucket_bytes)]
