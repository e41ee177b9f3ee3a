"""α–β collective cost models (paper Table 1 + Eq. 1).  Counterpart of
``repro.core.perfmodel.costs``.

All sizes in bytes, times in seconds.  ``bw`` is bytes/s per device (one
direction), ``alpha`` the per-hop latency.
"""
from __future__ import annotations

import math


def ring_all_reduce(n: float, p: int, bw: float, alpha: float) -> float:
    """Paper Eq. 1: T = 2α(p-1) + 2·n·(p-1)/(p·BW)."""
    if p <= 1:
        return 0.0
    return 2 * alpha * (p - 1) + 2 * n * (p - 1) / (p * bw)


def tree_all_reduce(n: float, p: int, bw: float, alpha: float) -> float:
    """Paper Table 1: latency 2α·log p, bandwidth 2β·n·log p."""
    if p <= 1:
        return 0.0
    lg = math.log2(p)
    return 2 * alpha * lg + 2 * n * lg / bw


def parameter_server(n: float, p: int, bw: float, alpha: float) -> float:
    """Paper Table 1: 2α + 2β(p-1)n (server-side bandwidth bound)."""
    if p <= 1:
        return 0.0
    return 2 * alpha + 2 * n * (p - 1) / bw


def all_gather(n: float, p: int, bw: float, alpha: float,
               congestion: float = 1.0) -> float:
    """Each device receives (p-1)·n bytes (paper App. B:
    T = n̂(p-1)/BW), optionally inflated by the incast congestion factor
    the paper observes for NCCL all-gather on EC2 (App. C)."""
    if p <= 1:
        return 0.0
    return alpha * (p - 1) + congestion * n * (p - 1) / bw


def reduce_scatter(n: float, p: int, bw: float, alpha: float) -> float:
    """Ring reduce-scatter of an n-byte vector: n·(p-1)/(p·BW)."""
    if p <= 1:
        return 0.0
    return alpha * (p - 1) + n * (p - 1) / (p * bw)


def all_to_all(n: float, p: int, bw: float, alpha: float) -> float:
    """n local bytes redistributed: n·(p-1)/(p·BW) per direction."""
    if p <= 1:
        return 0.0
    return alpha * (p - 1) + n * (p - 1) / (p * bw)


def broadcast(n: float, p: int, bw: float, alpha: float) -> float:
    """Ring broadcast of per-owner shards totalling n bytes: every device
    forwards/receives the (p-1)/p fraction it does not own — the same
    wire bytes as a ring all-gather but deterministic one-sender-per-shard
    ring traffic, so no incast congestion term (paper App. C's congestion
    is an all-gather/NCCL observation)."""
    if p <= 1:
        return 0.0
    return alpha * (p - 1) + n * (p - 1) / (p * bw)


def reduce_to_owner(n: float, p: int, bw: float, alpha: float) -> float:
    """Reduce an n-byte vector to its owner ranks (owner-aligned ring
    reduce-scatter): n·(p-1)/(p·BW) — HALF a ring all-reduce, the
    gradient leg of ``reduce_to_owner_broadcast``."""
    return reduce_scatter(n, p, bw, alpha)


def reduce_scatter_allgather(n: float, p: int, bw: float,
                             alpha: float) -> float:
    """The two-shot ring: reduce-scatter then all-gather — the explicit
    decomposition of Eq. 1's ring all-reduce (identical α-β cost)."""
    if p <= 1:
        return 0.0
    return reduce_scatter(n, p, bw, alpha) + \
        all_gather(n / p, p, bw, alpha)


def hierarchical_all_reduce(n: float, p: int, bw: float, alpha: float,
                            p_intra: int = 1,
                            dcn_bw: float = 0.0) -> float:
    """Two-tier mean: ring all-reduce over the p_intra intra-pod workers
    at the fast tier (``bw``), then ring all-reduce over the p/p_intra
    pods at the slow tier (``dcn_bw``, falling back to ``bw`` for
    single-tier hardware)."""
    if p <= 1:
        return 0.0
    p_i = max(1, min(p_intra, p))
    p_o = max(1, p // p_i)
    return ring_all_reduce(n, p_i, bw, alpha) + \
        ring_all_reduce(n, p_o, dcn_bw or bw, alpha)


def payload_collective(associative: bool, n: float, p: int, bw: float,
                       alpha: float, congestion: float = 1.0) -> float:
    """Cost of moving one compression payload under the ``auto`` comm
    plan — the analytical mirror of ``compression.base.reduce_payload``'s
    historic dispatch: associative payloads ring all-reduce (constant in
    p); the rest all-gather (linear in p, with the incast congestion
    factor)."""
    if associative:
        return ring_all_reduce(n, p, bw, alpha)
    return all_gather(n, p, bw, alpha, congestion)


def plan_collective(plan, associative: bool, n: float, p: int, bw: float,
                    alpha: float, congestion: float = 1.0,
                    p_intra: int = 1, dcn_bw: float = 0.0) -> float:
    """Cost of moving one payload under an explicit ``CommPlan`` — the
    analytical mirror of ``reduce_payload(payload, axes, plan)``, sharing
    the runtime's legality matrix (``CommPlan.validate``: mean-reducing
    plans require an associative payload; ``CommPlanError`` otherwise).

    ``reduce_to_owner_broadcast`` prices the gradient leg only (one ring
    reduce-scatter); its broadcast leg carries the owner's *product* and
    is costed by the consumer (ZeRO-1's param term — ``pm
    .zero1_gather_time(comm=...)``).
    """
    from repro_torch.parallel.commplan import CommPlan
    plan = CommPlan.parse(plan).resolve(associative)
    kind = plan.kind
    if kind == "allreduce":
        return ring_all_reduce(n, p, bw, alpha)
    if kind == "reduce_scatter_allgather":
        return reduce_scatter_allgather(n, p, bw, alpha)
    if kind == "reduce_to_owner_broadcast":
        return reduce_to_owner(n, p, bw, alpha)
    if kind == "gather_all":
        return all_gather(n, p, bw, alpha, congestion)
    if kind == "hierarchical":
        return hierarchical_all_reduce(n, p, bw, alpha, p_intra, dcn_bw)
    raise KeyError(kind)


COLLECTIVES = {
    "ring_all_reduce": ring_all_reduce,
    "tree_all_reduce": tree_all_reduce,
    "parameter_server": parameter_server,
    "all_gather": all_gather,
    "reduce_scatter": reduce_scatter,
    "reduce_scatter_allgather": reduce_scatter_allgather,
    "reduce_to_owner": reduce_to_owner,
    "broadcast": broadcast,
    "all_to_all": all_to_all,
}
