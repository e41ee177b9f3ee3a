"""What-if analysis (paper §4.2–4.3 + Appendix D) — the paper's tool.
Counterpart of ``repro.core.perfmodel.whatif``.

Each function reproduces one simulated figure and returns a plain table
(list of dicts) so benchmarks/tests/CLI can consume it uniformly.

Every sweep is a declarative ``Grid`` expansion evaluated by the
``repro_torch.experiments`` Runner: the function body builds
``ExperimentSpec``s (workload/hardware/method lifted into exact inline
fields) and maps the ``AnalyticBackend`` metrics back into the historical
row format.  The figure *is* its grid — the same specs can be persisted,
hashed, resumed, and re-run on a measured backend.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch.core.perfmodel import calibration as cal
from repro_torch.core.perfmodel import model as pm
from repro_torch.core.perfmodel.hardware import Hardware

def run_specs(specs):
    """Evaluate specs/Grid on an analytic Runner (no store: nothing to
    share between calls)."""
    from repro_torch.experiments import AnalyticBackend, Runner
    return Runner(AnalyticBackend()).run(specs)


def _base(w: pm.Workload, p: int, hw: Hardware,
          spec: pm.CompressionSpec | None = None):
    from repro_torch.experiments import (ExperimentSpec, hardware_fields,
                                   method_fields, workload_fields)
    fields = dict(workers=p, **workload_fields(w), **hardware_fields(hw))
    if spec is not None:
        fields.update(method_fields(spec))
    return ExperimentSpec(**fields)


def _metrics(r) -> dict:
    """Unwrap a Result, surfacing the backend's stored error (the Backend
    contract converts modeling exceptions into error Results; a figure
    sweep must fail with the real cause, not a KeyError)."""
    if not r.ok:
        raise RuntimeError(
            f"analytic backend failed for {r.spec.label()}: {r.error}")
    return r.metrics


def bandwidth_sweep(w: pm.Workload, p: int, hw: Hardware,
                    spec: pm.CompressionSpec,
                    gbps: Sequence[float] = (1, 2, 4, 8, 10, 15, 20, 30),
                    ) -> list[dict]:
    """Figs 3/17: syncSGD vs compression across network bandwidth."""
    from repro_torch.experiments import Grid
    grid = Grid.over(_base(w, p, hw, spec),
                     net_bw=[g * 1e9 / 8 for g in gbps])
    rows = []
    for g, r in zip(gbps, run_specs(grid)):
        m = _metrics(r)
        rows.append(dict(gbps=g, t_sync=m["t_sync_s"],
                         t_comp=m["t_method_s"], speedup=m["speedup"]))
    return rows


def batch_size_sweep(w: pm.Workload, p: int, hw: Hardware,
                     spec_builder, batches: Sequence[int] = (16, 32, 64),
                     ) -> list[dict]:
    """Fig 8: large batches hide communication, shrinking compression's edge."""
    from repro_torch.experiments import Grid, method_fields, workload_fields
    vals = []
    for b in batches:
        wb = cal.batch_scaled(w, b)
        vals.append(dict(batch=b, **workload_fields(wb),
                         **method_fields(spec_builder(wb))))
    grid = Grid.over(_base(w, p, hw), batch=vals)
    rows = []
    for b, r in zip(batches, run_specs(grid)):
        m = _metrics(r)
        rows.append(dict(batch=b, t_sync=m["t_sync_s"],
                         t_comp=m["t_method_s"], speedup=m["speedup"]))
    return rows


def required_compression_sweep(w: pm.Workload, p: int, hw: Hardware,
                               batches: Sequence[int] = (4, 8, 16, 32, 64),
                               ) -> list[dict]:
    """Figs 11/16: compression ratio needed for near-linear scaling."""
    from repro_torch.experiments import Grid, workload_fields
    vals = [dict(batch=b, **workload_fields(cal.batch_scaled(w, b)))
            for b in batches]
    grid = Grid.over(_base(w, p, hw), batch=vals)
    return [dict(batch=b, required_ratio=_metrics(r)["required_ratio"])
            for b, r in zip(batches, run_specs(grid))]


def compute_speedup_sweep(w: pm.Workload, p: int, hw: Hardware,
                          spec: pm.CompressionSpec,
                          speedups: Sequence[float] = (1, 1.5, 2, 2.5, 3, 3.5, 4),
                          ) -> list[dict]:
    """Fig 18: faster compute (encode-decode scales down too), fixed network."""
    from repro_torch.experiments import Grid, method_fields, workload_fields
    vals = []
    for s in speedups:
        spec_s = dataclasses.replace(spec,
                                     t_encode_decode=spec.t_encode_decode / s)
        vals.append(dict(**workload_fields(w.scaled_compute(s)),
                         **method_fields(spec_s)))
    grid = Grid.over(_base(w, p, hw), compute=vals)
    rows = []
    for s, r in zip(speedups, run_specs(grid)):
        m = _metrics(r)
        rows.append(dict(compute_speedup=s, t_sync=m["t_sync_s"],
                         t_comp=m["t_method_s"], speedup=m["speedup"]))
    return rows


def encode_tradeoff_sweep(w: pm.Workload, p: int, hw: Hardware,
                          spec: pm.CompressionSpec,
                          ks: Sequence[float] = (1, 2, 3, 4),
                          ls: Sequence[int] = (1, 2, 3)) -> list[dict]:
    """Fig 19: divide encode-decode by k while multiplying payload by k^l —
    'any reduction in encode time helps, even at reduced compression'."""
    from repro_torch.experiments import Grid, method_fields
    kls = [(k, l) for l in ls for k in ks]
    vals = [method_fields(dataclasses.replace(
                spec, name=f"{spec.name}-k{k:g}l{l}",
                t_encode_decode=spec.t_encode_decode / k,
                payload_bytes=tuple(b * (k ** l)
                                    for b in spec.payload_bytes)))
            for k, l in kls]
    grid = Grid.over(_base(w, p, hw), tradeoff=vals)
    return [dict(k=k, l=l, t_comp=_metrics(r)["t_method_s"],
                 t_sync=_metrics(r)["t_sync_s"])
            for (k, l), r in zip(kls, run_specs(grid))]


def scaling_curve(w: pm.Workload, hw: Hardware, spec: pm.CompressionSpec | None,
                  ps: Sequence[int] = (4, 8, 16, 32, 64, 96)) -> list[dict]:
    """Figs 5/6/7: per-iteration time vs #GPUs."""
    from repro_torch.experiments import Grid
    grid = Grid.over(_base(w, 1, hw, spec), workers=list(ps))
    rows = []
    for p, r in zip(ps, run_specs(grid)):
        m = _metrics(r)
        row = dict(p=p, t_linear=m["t_linear_s"], t_sync=m["t_sync_s"])
        if spec is not None:
            row["t_comp"] = m["t_method_s"]
        rows.append(row)
    return rows


def choose_policy(model_bytes: float, t_comp: float, p: int, hw: Hardware,
                  candidate_specs: Iterable[pm.CompressionSpec]) -> str:
    """The paper's contribution as a scheduling decision: given a link, pick
    raw syncSGD or the best compression scheme.  Used by the launcher to
    decide per-mesh-axis policy."""
    from repro_torch.experiments import Grid, method_fields
    w = pm.Workload("query", model_bytes, t_comp)
    candidates = list(candidate_specs)
    grid = Grid.over(_base(w, p, hw),
                     scheme=[method_fields(c) for c in candidates])
    results = run_specs(grid)
    best_name = "none"
    best_t = _metrics(results[0])["t_sync_s"] if results else \
        pm.sync_sgd_time(w, p, hw)
    for c, r in zip(candidates, results):
        if _metrics(r)["t_method_s"] < best_t:
            best_name, best_t = c.name, _metrics(r)["t_method_s"]
    return best_name
