"""Paper-published constants + fitted calibration (App. C methodology).
Counterpart of ``repro.core.perfmodel.calibration``.

Directly published (Table 2, ResNet-50 @ V100 bs64):
    backward ≈ 122 ms; encode-decode: PowerSGD r4/r8/r16 = 45/64/130 ms,
    MSTop-K 1%/0.1% = 103/104 ms, SignSGD = 16.34 ms.
Model sizes (§3): ResNet-50 97 MB, ResNet-101 170 MB, BERT_BASE 418 MB.

Published end-to-end anchors (96 GPUs, 10 Gb/s):
    syncSGD ResNet-101 ≈ 262 ms; SignSGD ResNet-101 ≈ 1042 ms;
    PowerSGD ResNet-101 ≈ 470 ms (rank unspecified in the text);
    BERT gap-to-linear ≈ 200 ms (Fig. 9);
    crossover bandwidth ≈ 8.2 Gb/s (Fig. 3: R101, bs64, 64 GPUs, rank-4).

Constants the paper measured but did not publish (T_comp / T_enc-dec for
ResNet-101 and BERT) are FITTED here to the anchor set and documented; the
per-model encode-decode times scale Table 2 by parameter bytes with a
kernel-launch-overhead factor (deeper nets pay more per-tensor launches,
App. E notes per-tensor JIT'd compression).

Known tension in the published numbers (documented, not hidden): the
"PowerSGD 470 ms" quote is inconsistent with Fig. 8's "rank-4 only 6.3%
slower than syncSGD at bs64/96 GPUs" under ANY constant assignment in the
paper's own model; we treat 470 ms as a rank-8..16 observation and verify it
falls inside our predicted band for those ranks.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.perfmodel.hardware import V100_EC2, Hardware
from repro_torch.core.perfmodel.model import CompressionSpec, Workload

MB = 2**20

# ---- published sizes / times ------------------------------------------------
RESNET50_BYTES = 97 * MB
RESNET101_BYTES = 170 * MB
BERT_BYTES = 418 * MB

TABLE2_ENCODE_DECODE_MS = {           # ResNet-50, V100 (paper Table 2)
    "powersgd-r4": 45.0,
    "powersgd-r8": 64.0,
    "powersgd-r16": 130.0,
    "mstopk-0.01": 103.0,
    "mstopk-0.001": 104.0,
    "signsgd": 16.34,
}
TABLE2_RATIOS = {
    "powersgd-r4": 72.0, "powersgd-r8": 37.0, "powersgd-r16": 19.0,
    "mstopk-0.01": 100.0, "mstopk-0.001": 1000.0, "signsgd": 32.0,
}

T_COMP_RESNET50 = 0.122               # paper Table 2 caption

# ---- fitted constants (documented derivation in module docstring) -----------
T_COMP_RESNET101 = 0.210              # ≈1.7× ResNet-50 (param & depth ratio)
T_COMP_BERT = 0.550                   # fits Fig. 9's 200 ms gap at 96 GPUs
# encode-decode launch-overhead factor, fitted to the paper's end-to-end
# claims: ResNet-101's many small conv tensors pay MORE per-byte overhead
# than ResNet-50 (1.5x); BERT's few large matmul-shaped tensors amortize
# launches far better (0.35x) — fitted to Fig 5's "+18.8% (r4) / +11.3%
# (r8) at 96 GPUs" which is impossible under byte-proportional scaling.
LAUNCH_OVERHEAD = {"resnet101": 1.5, "bert": 0.35}

PAPER_HW: Hardware = dataclasses.replace(
    V100_EC2, alpha=10e-6, allgather_congestion=2.0)

# ---- workloads ---------------------------------------------------------------
RESNET50 = Workload("resnet50", RESNET50_BYTES, T_COMP_RESNET50)
RESNET101 = Workload("resnet101", RESNET101_BYTES, T_COMP_RESNET101)
BERT = Workload("bert-base", BERT_BYTES, T_COMP_BERT)
WORKLOADS = {w.name: w for w in (RESNET50, RESNET101, BERT)}


def batch_scaled(w: Workload, batch: int, base_batch: int = 64) -> Workload:
    """Weak scaling: T_comp ∝ per-worker batch (paper §3.3)."""
    return dataclasses.replace(w, name=f"{w.name}-bs{batch}",
                               t_comp=w.t_comp * batch / base_batch)


def encode_decode_time(method: str, workload: Workload) -> float:
    """Scale Table 2 to other models: bytes-proportional × launch overhead."""
    base_ms = TABLE2_ENCODE_DECODE_MS[method]
    scale = workload.model_bytes / RESNET50_BYTES
    overhead = 1.0
    if workload.name.startswith("resnet101"):
        overhead = LAUNCH_OVERHEAD["resnet101"]
    elif workload.name.startswith("bert"):
        overhead = LAUNCH_OVERHEAD["bert"]
    return base_ms * 1e-3 * scale * overhead


def paper_spec(method: str, workload: Workload) -> CompressionSpec:
    """CompressionSpec for a paper-studied method on a paper workload."""
    t_ed = encode_decode_time(method, workload)
    ratio = TABLE2_RATIOS[method]
    payload = workload.model_bytes / ratio
    if method.startswith("powersgd"):
        # two all-reduces (P and Q), ~half the payload each
        return CompressionSpec(method, t_ed, (payload / 2, payload / 2), True)
    if method.startswith("mstopk"):
        # values + indices all-gathers (each half of the 8B/element payload)
        return CompressionSpec(method, t_ed, (payload / 2, payload / 2), False)
    if method == "signsgd":
        return CompressionSpec(method, t_ed, (payload,), False)
    raise KeyError(method)


def spec_from_compressor(comp, n_elements: int, t_encode_decode: float,
                         itemsize: int = 4) -> CompressionSpec:
    """Bridge: build a perf-model spec from a live Compressor instance.
    Payload bytes are derived per collective round from the compressor's
    actual encoded payloads (see ``CompressionSpec.for_compressor``)."""
    return CompressionSpec.for_compressor(comp, n_elements, t_encode_decode,
                                          itemsize)


# ---- pod calibration: measured multi-process runs -> fitted hardware --------
@dataclasses.dataclass(frozen=True)
class PodObservation:
    """One measured pod cell reduced to the α–β model's coordinates
    (built from a ``MultiProcessBackend`` Result by
    ``observations_from_results``)."""
    label: str
    spec_hash: str
    workload: str
    p: int                     # total DP workers (procs × local devices)
    p_intra: int               # fast-tier workers per process
    comm: str                  # "allreduce" | "hierarchical" (resolved)
    grad_bytes: float
    t_step: float              # measured serial pod step (s)
    t_compute: float           # measured local single-device step (s)


def _resolve_pod_comm(comm: str) -> str:
    """Collapse a CommPlan kind to the two α–β shapes a pod ring can
    take: one ring spanning both tiers (gated by the slow link) or the
    two-stage hierarchical split."""
    kind = str(comm).split(":")[0]
    if kind in ("auto", "allreduce", "reduce_scatter_allgather"):
        return "allreduce"
    if kind == "hierarchical":
        return "hierarchical"
    raise ValueError(f"no pod α–β shape for comm={comm!r}")


def observations_from_results(results) -> list[PodObservation]:
    """Extract the calibratable pod observations from a sweep: ok rows
    whose metrics carry the pod_worker record (``procs >= 2`` with
    measured serial/compute times and the gradient byte count)."""
    obs = []
    for r in results:
        m = r.metrics
        if not (r.ok and m.get("procs", 0) >= 2
                and "t_serial_us" in m and "t_compute_us" in m
                and "grad_bytes" in m):
            continue
        obs.append(PodObservation(
            label=r.spec.label(), spec_hash=r.spec.spec_hash(),
            workload=m.get("arch", r.spec.workload),
            p=int(m["workers"]), p_intra=int(m["local_devices"]),
            comm=_resolve_pod_comm(m.get("comm", r.spec.comm)),
            grad_bytes=float(m["grad_bytes"]),
            t_step=m["t_serial_us"] * 1e-6,
            t_compute=m["t_compute_us"] * 1e-6))
    # sorted by content hash: the fit is exactly invariant to the order
    # results arrive in (property-tested)
    return sorted(obs, key=lambda o: o.spec_hash)


def _pod_features(o: PodObservation) -> tuple[float, float, float]:
    """Coefficients of the unknowns ``[alpha, 1/net_bw, 1/dcn_bw]`` in
    the cell's collective time — EXACTLY the terms of
    ``costs.ring_all_reduce`` / ``costs.hierarchical_all_reduce``, so a
    synthetic observation generated from ``predict_pod_step`` round-trips
    through the fit with zero residual."""
    n, p = o.grad_bytes, o.p
    if p <= 1:
        return (0.0, 0.0, 0.0)
    if o.comm == "hierarchical":
        p_i = max(1, min(o.p_intra, p))
        p_o = max(1, p // p_i)
        return (2.0 * (p_i - 1) + 2.0 * (p_o - 1),
                2.0 * n * (p_i - 1) / p_i,
                2.0 * n * (p_o - 1) / p_o)
    # single ring spanning both tiers: every hop crosses the slow link
    return (2.0 * (p - 1), 0.0, 2.0 * n * (p - 1) / p)


def predict_pod_step(o: PodObservation, hw: Hardware) -> float:
    """The analytic serial pod step: measured compute offset + the α–β
    collective (``perfmodel.costs``) on ``hw``'s two tiers."""
    from repro_torch.core.perfmodel import costs
    if o.comm == "hierarchical":
        t_coll = costs.hierarchical_all_reduce(
            o.grad_bytes, o.p, hw.net_bw, hw.alpha, o.p_intra, hw.dcn_bw)
    else:
        t_coll = costs.ring_all_reduce(
            o.grad_bytes, o.p, hw.dcn_bw or hw.net_bw, hw.alpha)
    return o.t_compute + t_coll


@dataclasses.dataclass
class CalibrationFit:
    """A fitted two-tier Hardware + per-cell model-vs-measured rows."""
    hardware: Hardware
    rows: list
    n_obs: int

    @property
    def max_abs_rel_err(self) -> float:
        return max((abs(r["model_rel_err"]) for r in self.rows),
                   default=0.0)


def calibrate_from_results(results, base_hw: Hardware | None = None,
                           ) -> CalibrationFit:
    """Least-squares fit of ``[alpha, 1/net_bw, 1/dcn_bw]`` to the
    measured pod cells of a sweep (the sim-to-real loop).

    Each pod_worker record carries its own measured compute offset
    (``t_compute_us``, a local single-device run of the same per-device
    workload), so the residual ``t_serial - t_compute`` is purely the
    collective, linear in the three unknowns.  Unidentifiable columns
    (e.g. no hierarchical cell -> nothing constrains ``1/net_bw``) fall
    back to ``base_hw``; non-physical fits (negative latency/bandwidth,
    possible under timer noise) are clamped to the base value.  Rows are
    ordered by spec hash internally, so the fit is exactly invariant to
    result ordering.
    """
    import numpy as np

    from repro_torch.core.perfmodel.hardware import CPU_HOST
    base = base_hw or CPU_HOST
    obs = observations_from_results(list(results))
    if not obs:
        raise ValueError("no calibratable pod observations "
                         "(need ok procs>=2 train cells)")
    A = np.array([_pod_features(o) for o in obs], dtype=np.float64)
    b = np.array([o.t_step - o.t_compute for o in obs], dtype=np.float64)
    fitted = dict(alpha=base.alpha, net_bw=base.net_bw,
                  dcn_bw=base.dcn_bw or base.net_bw)
    keep = [j for j in range(3) if np.any(A[:, j] != 0.0)]
    if keep:
        x, *_ = np.linalg.lstsq(A[:, keep], b, rcond=None)
        names = ["alpha", "inv_net", "inv_dcn"]
        sol = dict(zip((names[j] for j in keep), x))
        if "alpha" in sol and sol["alpha"] >= 0.0:
            fitted["alpha"] = float(sol["alpha"])
        if sol.get("inv_net", 0.0) > 0.0:
            fitted["net_bw"] = float(1.0 / sol["inv_net"])
        if sol.get("inv_dcn", 0.0) > 0.0:
            fitted["dcn_bw"] = float(1.0 / sol["inv_dcn"])
    hw = dataclasses.replace(base, name=f"{base.name}-fit", **fitted)
    rows = []
    for o in obs:
        t_model = predict_pod_step(o, hw)
        rows.append(dict(
            label=o.label, spec_hash=o.spec_hash,
            comm=o.comm, p=o.p, p_intra=o.p_intra,
            t_measured_s=o.t_step, t_model_s=t_model,
            # sign convention: positive = the model over-predicts
            model_rel_err=(t_model - o.t_step) / o.t_step))
    return CalibrationFit(hardware=hw, rows=rows, n_obs=len(obs))


def attach_model_error(results, fit: CalibrationFit):
    """Return the sweep with the fit's model-vs-measured columns merged
    into each pod cell's metrics (``t_model_s`` / ``t_measured_s`` /
    ``model_rel_err``) — what ``report.headline()`` renders as the
    error column.  Non-pod rows pass through unchanged."""
    by_hash = {row["spec_hash"]: row for row in fit.rows}
    out = []
    for r in results:
        row = by_hash.get(r.spec.spec_hash())
        if row is None:
            out.append(r)
            continue
        out.append(dataclasses.replace(r, metrics=dict(
            r.metrics, t_model_s=row["t_model_s"],
            t_measured_s=row["t_measured_s"],
            model_rel_err=row["model_rel_err"])))
    return out


# ---- published end-to-end anchors (for verification) ------------------------
ANCHORS = {
    # (workload, method, p) -> observed seconds
    ("resnet101", "syncsgd", 96): 0.262,
    ("resnet101", "signsgd", 96): 1.042,
    ("resnet101", "powersgd-r8..r16", 96): 0.470,
    ("bert-base", "gap_to_linear", 96): 0.200,
    ("resnet101", "crossover_gbps_r4_64gpu", 64): 8.2,
}
