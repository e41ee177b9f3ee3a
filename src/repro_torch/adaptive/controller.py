"""The runtime adaptive controller: per-bucket decisions, measured
feedback, hysteresis.  Counterpart of ``repro.adaptive.controller``.

At step boundaries the controller re-prices every per-bucket candidate
(``adaptive.policy``) with an EMA-corrected model: each scheme's analytic
prediction is multiplied by the exponential moving average of
measured/predicted ratios from step timers fed to :meth:`observe`, and
the controller picks ``{scheme, rank/k, CommPlan}`` per bucket.  A change
of decision means a new aggregator and step, so switching is gated by a
hysteresis band (a challenger must beat the incumbent's corrected time by
``hysteresis`` relative) and the controller cannot thrash on noise inside
the band.

The launch-time entry point is :func:`resolve_plan` (``launch.train
--adaptive``, ``ParallelPlan.adaptive``): one whole-model decision that
fixes the plan's ``compression``/``comm``/``overlap`` fields before the
step is built.  The arithmetic is the JAX package's, in the same order,
so the decisions and floats are its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.adaptive import policy
from repro_torch.core.perfmodel import model as pm
from repro_torch.core.perfmodel.hardware import Hardware


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    #: relative predicted win required before leaving the baseline at all
    margin: float = 0.0
    #: relative corrected-time improvement a challenger must show over the
    #: incumbent before the controller switches to it (the thrash gate)
    hysteresis: float = 0.10
    #: weight of the newest measured/predicted ratio in the EMA blend
    ema: float = 0.5


class BucketController:
    """Per-bucket adaptive decisions over one workload.

    ``bucket_bytes`` are the bucket byte sizes (the train step's
    ``setup.layout``); each bucket is priced as a mini-workload carrying
    its share of backward compute (``policy.bucket_workloads``).
    """

    def __init__(self, w: pm.Workload, p: int, hw: Hardware,
                 bucket_bytes: Sequence[float],
                 candidates: Optional[Sequence[policy.Candidate]] = None,
                 cfg: ControllerConfig = ControllerConfig()):
        self.w = w
        self.p = p
        self.hw = hw
        self.cfg = cfg
        self.bucket_ws = policy.bucket_workloads(w, bucket_bytes)
        self.candidates = list(candidates if candidates is not None
                               else policy.paper_candidates(w))
        #: scheme name -> EMA of measured/predicted step-time ratio
        self._ema: dict[str, float] = {}
        self.decisions: list[policy.Decision] = [
            self._decide(bw, incumbent=None) for bw in self.bucket_ws]

    # ---- the corrected model -------------------------------------------
    def _factor(self, scheme: str) -> float:
        return self._ema.get(scheme, 1.0)

    def _priced(self, bw: pm.Workload) -> list[tuple[str, str, float]]:
        """[(scheme, comm, corrected predicted time)] for one bucket,
        baseline first."""
        from repro_torch.parallel.commplan import CommPlanError
        out = [("syncsgd", "auto",
                pm.sync_sgd_plan_time(bw, self.p, self.hw)
                * self._factor("syncsgd"))]
        for c in self.candidates:
            try:
                t = pm.compressed_plan_time(bw, self.p, self.hw, c.spec,
                                            c.comm)
            except CommPlanError:
                continue
            out.append((c.method, c.comm, t * self._factor(c.method)))
        return out

    def _decide(self, bw: pm.Workload,
                incumbent: Optional[policy.Decision]) -> policy.Decision:
        priced = self._priced(bw)
        t_base = priced[0][2]
        scheme, comm, t = min(priced, key=lambda r: r[2])
        if scheme != "syncsgd" and not t < t_base * (1 - self.cfg.margin):
            scheme, comm, t = priced[0]
        if incumbent is not None and scheme != incumbent.scheme:
            # hysteresis: the challenger must beat the incumbent's own
            # corrected time by the band, or the incumbent stands
            t_inc = next((ti for s, _, ti in priced
                          if s == incumbent.scheme), None)
            if t_inc is not None and not t < t_inc * (1 -
                                                      self.cfg.hysteresis):
                return dataclasses.replace(incumbent, t_pred=t_inc,
                                           t_base=t_base)
        return policy.Decision(scheme=scheme, comm=comm, t_pred=t,
                               t_base=t_base, win=scheme != "syncsgd")

    # ---- measured feedback ---------------------------------------------
    def observe(self, scheme: str, measured_s: float,
                predicted_s: Optional[float] = None) -> None:
        """Fold one measured step time into the scheme's EMA correction
        factor.  ``predicted_s`` defaults to the uncorrected whole-model
        analytic prediction."""
        if predicted_s is None:
            predicted_s = self._predict_raw(scheme)
        if predicted_s <= 0:
            return
        ratio = measured_s / predicted_s
        a = self.cfg.ema
        prev = self._ema.get(scheme)
        self._ema[scheme] = ratio if prev is None else \
            a * ratio + (1 - a) * prev

    def _predict_raw(self, scheme: str) -> float:
        if scheme == "syncsgd":
            return pm.sync_sgd_plan_time(self.w, self.p, self.hw)
        for c in self.candidates:
            if c.method == scheme:
                return pm.compressed_plan_time(self.w, self.p, self.hw,
                                               c.spec, c.comm)
        raise KeyError(f"unknown scheme {scheme!r}")

    # ---- the step boundary ---------------------------------------------
    def step(self) -> bool:
        """Re-decide every bucket against the corrected model.  Returns
        True iff any decision changed: the caller's signal to rebuild the
        step."""
        new = [self._decide(bw, incumbent=self.decisions[i])
               for i, bw in enumerate(self.bucket_ws)]
        changed = any(n.scheme != o.scheme or n.comm != o.comm
                      for n, o in zip(new, self.decisions))
        self.decisions = new
        return changed

    def summary(self) -> dict:
        """One JSON-able record of the current per-bucket choices."""
        return dict(
            buckets=[dict(scheme=d.scheme, comm=d.comm,
                          t_pred_s=d.t_pred, t_base_s=d.t_base)
                     for d in self.decisions],
            schemes=sorted({d.scheme for d in self.decisions}),
            ema={k: round(v, 4) for k, v in sorted(self._ema.items())})


# ---------------------------------------------------------------------------
# launch-time plan resolution
# ---------------------------------------------------------------------------
def _param_count(arch_cfg) -> int:
    """The model's parameter count (``models.registry``, as the JAX
    package's ``ArchConfig.param_count``)."""
    return arch_cfg.param_count()


def workload_for_arch(arch_cfg, batch: int, seq: int,
                      hw: Hardware) -> pm.Workload:
    """A rough analytic Workload for a registered arch: fp32 gradient
    bytes from the exact param count, backward compute from the dense
    2·2·params·tokens FLOP estimate at 40% MFU.  Launch-time decisions
    only need relative leg sizes, and the measured EMA corrects the
    absolute scale after the first steps."""
    params = _param_count(arch_cfg)
    flops = 2 * 2 * params * batch * seq
    return pm.Workload(name=arch_cfg.name, model_bytes=4.0 * params,
                       t_comp=flops / (hw.peak_flops * 0.4))


def resolve_plan(plan, arch_cfg, n_dev: int, batch: int = 8, seq: int = 64,
                 hw: Optional[Hardware] = None,
                 cfg: ControllerConfig = ControllerConfig()):
    """Make an adaptive ``ParallelPlan`` static: one whole-model
    :func:`policy.decide` pass picks ``compression``/``comm`` (falling
    back to overlapped syncSGD), and the result carries ``adaptive=False``
    so the rest of the stack sees an ordinary plan.  Returns ``(plan,
    decision)``."""
    from repro_torch.core.perfmodel import calibration as cal
    hw = hw if hw is not None else cal.PAPER_HW
    w = workload_for_arch(arch_cfg, batch, seq, hw)
    d = policy.decide(w, n_dev, hw, _live_candidates(plan, hw), cfg.margin)
    repl = dict(adaptive=False, overlap=True, dp_mode="ddp")
    if d.is_baseline:
        repl["compression"] = "none"
    else:
        repl["compression"] = d.scheme
        repl["comm"] = d.comm
    return dataclasses.replace(plan, **repl), d


def _live_candidates(plan, hw: Hardware) -> list[policy.Candidate]:
    """Launch-time candidate pool: the live associative schemes (they keep
    the overlapped ring pipeline) at the plan's knob values, priced by
    their derived wire bytes."""
    from repro_torch.core.compression import base as cbase
    out = []
    for name in ("powersgd", "ef:randomk"):
        comp = cbase.make(name, **cbase.plan_kwargs_for(name, plan))
        n = 1 << 22   # pricing bucket: 4M elements
        eff = 0.4 if "powersgd" in name else 0.05
        t_ed = comp.encode_decode_flops(n) / (hw.peak_flops * eff)
        out.append(policy.Candidate(
            name, pm.CompressionSpec.for_compressor(comp, n, t_ed), "auto"))
    return out
