"""The paper's analytical performance model (§4.1 + Appendix B).

syncSGD (overlap + bucketing, PyTorch DDP):

    T_obs ≈ max(γ·T_comp, (k-1)·T_comm(b, p, BW)) + T_comm(b̂, p, BW)

compression (best case = post-backward, paper Takeaway 1):

    T_obs ≈ T_comp + T_encode-decode + Σ T_comm(compressed payloads)

Counterpart of ``repro.core.perfmodel.model``: the same formulas on the
same floats, so both packages give the same times bit for bit.  The model
takes measured constants (the paper's) or a fitted ``Hardware``
(``calibration.calibrate_from_results``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.perfmodel import costs
from repro_torch.core.perfmodel.hardware import Hardware


@dataclasses.dataclass(frozen=True)
class Workload:
    """A data-parallel training step, as the paper parameterizes it."""
    name: str
    model_bytes: float            # gradient size (fp32 in the paper)
    t_comp: float                 # single-device backward time (s)
    # forward time is excluded in the paper's T_obs (it measures backward +
    # sync); keep optional for end-to-end what-ifs
    t_fwd: float = 0.0

    def scaled_compute(self, speedup: float) -> "Workload":
        return dataclasses.replace(
            self, t_comp=self.t_comp / speedup, t_fwd=self.t_fwd / speedup)


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Perf-model view of a compressor (paper Table 2 + App. B)."""
    name: str
    t_encode_decode: float            # seconds, single device
    payload_bytes: tuple[float, ...]  # per-collective wire payloads
    all_reduce_compatible: bool

    @property
    def total_payload(self) -> float:
        return sum(self.payload_bytes)

    @property
    def associative(self) -> bool:
        return self.all_reduce_compatible

    def compression_ratio(self, model_bytes: float) -> float:
        return model_bytes / max(self.total_payload, 1e-12)

    @classmethod
    def for_compressor(cls, comp, n_elements: int, t_encode_decode: float,
                       itemsize: int = 4) -> "CompressionSpec":
        """Build the spec from a live ``Compressor``: one payload entry per
        collective round, with bytes derived from the actual encoded
        payloads (``wire_round_bytes``) — nothing hand-maintained."""
        return cls(comp.name, t_encode_decode,
                   tuple(float(b) for b in
                         comp.wire_round_bytes(n_elements, itemsize)),
                   comp.associative)


GAMMA_DEFAULT = 1.05   # paper: observed 1.04–1.1
BUCKET_BYTES_DEFAULT = 25 * 2**20


def sync_sgd_time(w: Workload, p: int, hw: Hardware,
                  bucket_bytes: float = BUCKET_BYTES_DEFAULT,
                  gamma: float = GAMMA_DEFAULT) -> float:
    """Optimized syncSGD per-iteration backward+sync time (paper §4.1)."""
    if p <= 1:
        return w.t_comp
    k = max(1, math.ceil(w.model_bytes / bucket_bytes))
    b = bucket_bytes if k > 1 else w.model_bytes
    b_hat = w.model_bytes - (k - 1) * bucket_bytes if k > 1 else w.model_bytes
    overlapped = (k - 1) * costs.ring_all_reduce(b, p, hw.net_bw, hw.alpha)
    tail = costs.ring_all_reduce(b_hat, p, hw.net_bw, hw.alpha)
    return max(gamma * w.t_comp, overlapped) + tail


def sync_sgd_serial_time(w: Workload, p: int, hw: Hardware) -> float:
    """syncSGD *without* overlap (paper Fig 2's strawman): the full
    backward, then one serial all-reduce of the whole gradient.  The
    executable mirror is ``repro_torch.train.overlap``'s serial/unfused
    schedules."""
    if p <= 1:
        return w.t_comp
    return w.t_comp + costs.ring_all_reduce(w.model_bytes, p, hw.net_bw,
                                            hw.alpha)


def compressed_time(w: Workload, p: int, hw: Hardware,
                    spec: CompressionSpec) -> float:
    """Gradient-compression per-iteration time (paper App. B).

    Each payload round pays the collective its associativity selects
    (``costs.payload_collective`` — the analytical mirror of the runtime
    reduce phase)."""
    if p <= 1:
        return w.t_comp
    comm = sum(
        costs.payload_collective(spec.associative, payload, p, hw.net_bw,
                                 hw.alpha, hw.allgather_congestion)
        for payload in spec.payload_bytes)
    return w.t_comp + spec.t_encode_decode + comm


def zero1_gather_time(w: Workload, p: int, hw: Hardware,
                      param_bytes_frac: float = 0.5,
                      comm: str = "auto") -> float:
    """The comm ZeRO-1 adds on top of any gradient-exchange scheme: after
    the sharded update, each rank's owned parameter shard (~model/p
    elements, working-dtype — bf16 working params at half the fp32
    gradient bytes by default) reaches every peer.  Mirrors
    ``train_step.zero1_apply``'s Payload gather; applies equally to the
    syncSGD baseline and to every compression leg, so it shifts absolute
    times, not just the baseline.

    Under the ``reduce_to_owner_broadcast`` comm plan the exchange is the
    owner's ring *broadcast* — same bytes, but deterministic
    one-sender-per-shard traffic, so it skips the all-gather incast
    congestion factor (paper App. C) the default gather pays."""
    if p <= 1:
        return 0.0
    n = w.model_bytes * param_bytes_frac / p
    if comm == "reduce_to_owner_broadcast":
        return costs.broadcast(n * p, p, hw.net_bw, hw.alpha)
    return costs.all_gather(n, p, hw.net_bw, hw.alpha,
                            hw.allgather_congestion)


def _plan_kw(hw: Hardware, p: int, pods: int = 2) -> dict:
    """Shared plan_collective keyword bridge: the hierarchical split puts
    ``pods`` groups on the slow (DCN) tier when the hardware has one."""
    return dict(congestion=hw.allgather_congestion,
                p_intra=max(1, p // pods) if hw.dcn_bw else p,
                dcn_bw=hw.dcn_bw)


def sync_sgd_plan_time(w: Workload, p: int, hw: Hardware,
                       comm: str = "auto",
                       bucket_bytes: float = BUCKET_BYTES_DEFAULT,
                       gamma: float = GAMMA_DEFAULT) -> float:
    """Optimized syncSGD under an explicit comm plan: the same
    overlap-and-bucket structure as :func:`sync_sgd_time`, but every
    bucket collective priced by ``costs.plan_collective`` — the knob that
    lets the matrix ask "does compression still lose when syncSGD pays
    gather-based costs?" (``comm="gather_all"``).  ``auto``/``allreduce``
    reproduce :func:`sync_sgd_time` exactly.  A ``gather_all`` or
    ``reduce_to_owner_broadcast`` baseline cannot pipeline its buckets
    (commplan.OVERLAPPABLE — the runtime degrades to the serial
    schedule), so those plans pay compute + full comm serially."""
    from repro_torch.parallel import commplan as cp
    plan = cp.CommPlan.parse(comm).resolve(True)
    if plan.kind == "allreduce":
        return sync_sgd_time(w, p, hw, bucket_bytes, gamma)
    if p <= 1:
        return w.t_comp
    kw = _plan_kw(hw, p)
    k = max(1, math.ceil(w.model_bytes / bucket_bytes))
    b = bucket_bytes if k > 1 else w.model_bytes
    b_hat = w.model_bytes - (k - 1) * bucket_bytes if k > 1 \
        else w.model_bytes
    t_b = costs.plan_collective(plan, True, b, p, hw.net_bw, hw.alpha,
                                **kw)
    t_tail = costs.plan_collective(plan, True, b_hat, p, hw.net_bw,
                                   hw.alpha, **kw)
    if plan.kind in cp.OVERLAPPABLE:
        return max(gamma * w.t_comp, (k - 1) * t_b) + t_tail
    return w.t_comp + (k - 1) * t_b + t_tail


def sync_sgd_serial_plan_time(w: Workload, p: int, hw: Hardware,
                              comm: str = "auto") -> float:
    """The Fig-2 serial strawman under an explicit comm plan: full
    backward, then ONE whole-model collective of the plan's shape.
    ``auto``/``allreduce`` reproduce :func:`sync_sgd_serial_time`."""
    from repro_torch.parallel import commplan as cp
    plan = cp.CommPlan.parse(comm).resolve(True)
    if plan.kind == "allreduce":
        return sync_sgd_serial_time(w, p, hw)
    if p <= 1:
        return w.t_comp
    return w.t_comp + costs.plan_collective(
        plan, True, w.model_bytes, p, hw.net_bw, hw.alpha,
        **_plan_kw(hw, p))


def compressed_plan_time(w: Workload, p: int, hw: Hardware,
                         spec: CompressionSpec,
                         comm: str = "auto") -> float:
    """Gradient-compression time under an explicit comm plan: each
    payload round pays ``costs.plan_collective`` (which enforces the
    legality matrix — a non-associative payload under a mean-reducing
    plan raises ``CommPlanError``, exactly like the runtime).
    ``auto`` reproduces :func:`compressed_time` exactly."""
    from repro_torch.parallel import commplan as cp
    plan = cp.CommPlan.parse(comm)
    if plan.kind == "auto":
        return compressed_time(w, p, hw, spec)
    if p <= 1:
        return w.t_comp
    kw = _plan_kw(hw, p)
    comm_t = sum(
        costs.plan_collective(plan, spec.associative, payload, p,
                              hw.net_bw, hw.alpha, **kw)
        for payload in spec.payload_bytes)
    return w.t_comp + spec.t_encode_decode + comm_t


def grad_exchange_bytes(w: Workload, p: int, hw: Hardware,
                        comm: str = "auto") -> float:
    """Per-device effective wire bytes of one gradient exchange under a
    comm plan (``CommPlan.wire_bytes`` — the same object the runtime
    executes), at the hardware's congestion factor.  The currency of the
    bench comm anchors."""
    from repro_torch.parallel import commplan as cp
    plan = cp.CommPlan.parse(comm).resolve(True)
    return plan.wire_bytes(w.model_bytes, p, hw.allgather_congestion,
                           p_intra=_plan_kw(hw, p)["p_intra"])


def zero1_exchange_bytes(w: Workload, p: int, hw: Hardware,
                         param_bytes_frac: float = 0.5,
                         comm: str = "auto") -> float:
    """Per-device param-leg bytes of the ZeRO-1 post-update exchange:
    the all-gather pays the incast congestion factor; the
    ``reduce_to_owner_broadcast`` broadcast leg is congestion-free ring
    traffic (same formula :func:`zero1_gather_time` prices)."""
    if p <= 1:
        return 0.0
    n = w.model_bytes * param_bytes_frac
    if comm == "reduce_to_owner_broadcast":
        return n * (p - 1) / p
    return hw.allgather_congestion * n * (p - 1) / p


def accum_scaled(w: Workload, accum: int) -> Workload:
    """Gradient accumulation multiplies the per-step compute leg while the
    per-step comm stays one sync — the amortization that shrinks
    compression's addressable gap (Zhang et al.; Han et al.)."""
    return w if accum <= 1 else dataclasses.replace(
        w, t_comp=w.t_comp * accum, t_fwd=w.t_fwd * accum)


def linear_scaling_time(w: Workload) -> float:
    """Ideal weak-scaling iteration time (= single-device backward)."""
    return w.t_comp


def speedup_vs_sync(w: Workload, p: int, hw: Hardware,
                    spec: CompressionSpec, **kw) -> float:
    return sync_sgd_time(w, p, hw, **kw) / compressed_time(w, p, hw, spec)


def gap_to_linear(w: Workload, p: int, hw: Hardware, **kw) -> float:
    """Paper Fig. 9: the headroom any compression scheme must fit inside."""
    return sync_sgd_time(w, p, hw, **kw) - linear_scaling_time(w)


def bucket_compressed_time(w: Workload, p: int, hw: Hardware, ratio: float,
                           t_encode_decode: float = 0.0,
                           bucket_bytes: float = BUCKET_BYTES_DEFAULT,
                           gamma: float = GAMMA_DEFAULT) -> float:
    """A hypothetical *overlappable* per-bucket compression scheme (paper
    Figs 11/16): each DDP bucket is compressed by `ratio` and ring-reduced in
    the same overlapped pipeline as syncSGD.  This is the idealized scheme
    the paper uses to ask "how much compression would linear scaling need?"
    (zero/low encode cost, all-reduce compatible, bucket-wise)."""
    if p <= 1:
        return w.t_comp
    k = max(1, math.ceil(w.model_bytes / bucket_bytes))
    b = (bucket_bytes if k > 1 else w.model_bytes) / ratio
    b_hat = (w.model_bytes - (k - 1) * bucket_bytes if k > 1
             else w.model_bytes) / ratio
    overlapped = (k - 1) * costs.ring_all_reduce(b, p, hw.net_bw, hw.alpha)
    tail = costs.ring_all_reduce(b_hat, p, hw.net_bw, hw.alpha)
    return (max(gamma * w.t_comp, overlapped) + tail + t_encode_decode)


def required_compression(w: Workload, p: int, hw: Hardware,
                         t_encode_decode: float = 0.0,
                         slack: float = 1.2,
                         gamma: float = GAMMA_DEFAULT,
                         max_ratio: float = 4096.0) -> float:
    """Paper Figs 11/16: smallest per-bucket compression ratio achieving
    near-linear scaling, T_obs <= slack · γ · T_comp (slack 1.2 = "within
    20% of linear", the threshold that reproduces the paper's "≤4× even at
    small batch" under its own α range).  Returns inf if even `max_ratio`
    cannot reach it (latency/encode-bound)."""
    target = slack * gamma * w.t_comp

    def t(ratio: float) -> float:
        return bucket_compressed_time(w, p, hw, ratio, t_encode_decode,
                                      gamma=gamma)

    if t(max_ratio) > target:
        return math.inf
    if t(1.0) <= target:
        return 1.0
    lo, hi = 1.0, max_ratio
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if t(mid) <= target:
            hi = mid
        else:
            lo = mid
    return hi


def crossover_bandwidth(w: Workload, p: int, hw: Hardware,
                        spec: CompressionSpec,
                        lo_gbps: float = 0.5, hi_gbps: float = 100.0,
                        **kw) -> Optional[float]:
    """Bandwidth (Gb/s) above which syncSGD beats the compression scheme
    (paper Fig. 3: ≈8.2 Gb/s for ResNet-101/64 GPUs/bs64/PowerSGD-r4).
    None if one of them dominates over the whole range."""
    def diff(gbps: float) -> float:
        h = hw.with_net(gbps)
        return sync_sgd_time(w, p, h, **kw) - compressed_time(w, p, h, spec)
    lo, hi = lo_gbps, hi_gbps
    if diff(lo) * diff(hi) > 0:
        return None
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if diff(lo) * diff(mid) <= 0:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)
