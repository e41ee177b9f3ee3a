"""The adaptive controller (``repro_torch.adaptive.controller``) against the
JAX package's ``repro.adaptive.controller``, exactly: the same decisions
and the same floats.

* ``resolve_plan`` over {full, reduced} ``tinyllama-1.1b`` x ``n_dev`` in
  {1, 2, 4, 8} x (batch, seq) in {(8, 64), (4, 512)}: the resolved plan
  field for field and the ``Decision``; ``chip_smoke.py``'s expected
  decision is JAX's.
* ``_live_candidates``: the same candidate specs for several plans.
* ``BucketController`` over the full-size ZeRO-1 layout's bucket bytes:
  the same decisions, ``step()`` results and ``summary()`` after the same
  seeded ``observe()`` sequence, and two built cases, one where the margin
  holds the baseline and one where the hysteresis band holds the
  incumbent against a cheaper challenger.
* The resolved plan builds in the port, and an adaptive ``kind="train"``
  cell through ``MeasuredBackend`` records JAX's ``adaptive_choice`` (one
  real CPU cell at one worker; the others with the subprocess replaced in
  both packages).
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from repro.adaptive import controller as jctl
from repro.configs import base as jcfgs
from repro.core.perfmodel import calibration as jcal
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import MeasuredBackend as JMeasured
from repro.experiments import backend as jbackend
from repro_torch.adaptive import controller as tctl
from repro_torch.configs import base as tcfgs
from repro_torch.core import bucketing
from repro_torch.core.perfmodel import calibration as tcal
from repro_torch.experiments import ExperimentSpec, MeasuredBackend
from repro_torch.experiments import backend as tbackend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _archs(full):
    j, t = jcfgs.get("tinyllama-1.1b"), tcfgs.get("tinyllama-1.1b")
    return (j, t) if full else (jcfgs.reduced(j), tcfgs.reduced(t))


def _asdict(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("bs", [(8, 64), (4, 512)], ids=["8x64", "4x512"])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_resolve_plan_matches_jax(full, n_dev, bs):
    ja, ta = _archs(full)
    batch, seq = bs
    jp, jd = jctl.resolve_plan(ja.plan, ja, n_dev, batch=batch, seq=seq)
    tp, td = tctl.resolve_plan(ta.plan, ta, n_dev, batch=batch, seq=seq)
    assert _asdict(tp) == _asdict(jp)
    assert _asdict(td) == _asdict(jd)
    assert tp.adaptive is False and tp.overlap and tp.dp_mode == "ddp"
    assert td.scheme == ("syncsgd" if n_dev == 1 else "powersgd")


def test_chip_smokes_expected_decision_is_jaxs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = smoke.ADAPTIVE_WANT
    ja = jcfgs.get("tinyllama-1.1b")
    plan, d = jctl.resolve_plan(ja.plan, ja, want["n_dev"],
                                batch=want["batch"], seq=want["seq"])
    assert (d.scheme, plan.comm, plan.overlap, plan.zero1) == (
        want["scheme"], want["comm"], True, True)


@pytest.mark.parametrize("overrides", [
    {}, dict(powersgd_rank=8), dict(powersgd_rank=1)],
    ids=["arch", "rank8", "rank1"])
def test_live_candidates_match_jax(overrides):
    ja, ta = _archs(True)
    jc = jctl._live_candidates(dataclasses.replace(ja.plan, **overrides),
                               jcal.PAPER_HW)
    tc = tctl._live_candidates(dataclasses.replace(ta.plan, **overrides),
                               tcal.PAPER_HW)
    assert [_asdict(c) for c in tc] == [_asdict(c) for c in jc]


# ------------------------------------------------------- BucketController
def _bucket_bytes():
    """The full-size ZeRO-1 layout's bucket bytes (bf16 buckets)."""
    import torch

    from repro_torch.models.layers import ShardCtx
    from repro_torch.models.model import Model
    arch = tcfgs.get("tinyllama-1.1b")
    model = Model(arch, ShardCtx(param_dtype=torch.bfloat16), device="meta")
    lay = bucketing.layout_for(list(model.parameters()), arch.plan.bucket_mb)
    return [2.0 * n for n in lay.sizes]


def _pair(p, cfg_kw, live):
    """The two packages' controllers over the same workload and buckets."""
    ja, ta = _archs(True)
    sizes = _bucket_bytes()
    jw = jctl.workload_for_arch(ja, 4, 512, jcal.PAPER_HW)
    tw = tctl.workload_for_arch(ta, 4, 512, tcal.PAPER_HW)
    assert _asdict(tw) == _asdict(jw)
    jcand = jctl._live_candidates(ja.plan, jcal.PAPER_HW) if live else None
    tcand = tctl._live_candidates(ta.plan, tcal.PAPER_HW) if live else None
    j = jctl.BucketController(jw, p, jcal.PAPER_HW, sizes, jcand,
                              jctl.ControllerConfig(**cfg_kw))
    t = tctl.BucketController(tw, p, tcal.PAPER_HW, sizes, tcand,
                              tctl.ControllerConfig(**cfg_kw))
    return j, t


def _same(j, t):
    assert [_asdict(d) for d in t.decisions] == \
        [_asdict(d) for d in j.decisions]
    assert t.summary() == j.summary()


@pytest.mark.parametrize("live", [True, False], ids=["live", "paper"])
@pytest.mark.parametrize("cfg_kw", [{}, dict(margin=0.2, hysteresis=0.3,
                                             ema=0.25)],
                         ids=["default", "wide"])
@pytest.mark.parametrize("p", [2, 8])
def test_bucket_controller_matches_jax(p, cfg_kw, live):
    j, t = _pair(p, cfg_kw, live)
    _same(j, t)
    rng = np.random.default_rng(p)
    schemes = ["syncsgd"] + [c.method for c in t.candidates]
    for _ in range(12):
        s = schemes[rng.integers(len(schemes))]
        measured = j._predict_raw(s) * float(rng.uniform(0.05, 20.0))
        explicit = rng.uniform() < 0.25
        kw = dict(predicted_s=measured / 3) if explicit else {}
        j.observe(s, measured, **kw)
        t.observe(s, measured, **kw)
        cj, ct = j.step(), t.step()
        assert ct == cj
        _same(j, t)
    assert t.summary()["ema"] == j.summary()["ema"] != {}


def test_margin_holds_the_baseline():
    j, t = _pair(2, {}, True)
    assert {d.scheme for d in t.decisions} == {"powersgd"}
    j, t = _pair(2, dict(margin=0.99), True)
    _same(j, t)
    assert {d.scheme for d in t.decisions} == {"syncsgd"}
    assert all(d.t_pred > 0 and not d.win for d in t.decisions)


def test_hysteresis_holds_the_incumbent():
    """syncSGD is measured just under PowerSGD's corrected time: cheaper,
    but inside the band, so PowerSGD stays; a larger gap flips."""
    j, t = _pair(2, {}, True)
    w = t.bucket_ws[0]
    priced = dict((s, x) for s, _, x in t._priced(w))
    # scale syncSGD to 95% of PowerSGD's time on bucket 0
    ratio = 0.95 * priced["powersgd"] / priced["syncsgd"]
    for c in (j, t):
        c.observe("syncsgd", ratio * c._predict_raw("syncsgd"))
    assert t.step() is False and j.step() is False
    _same(j, t)
    priced = {s: x for s, _, x in t._priced(w)}
    assert priced["syncsgd"] < priced["powersgd"]
    assert t.decisions[0].scheme == "powersgd"
    assert t.decisions[0].t_pred == priced["powersgd"]
    for c in (j, t):
        for _ in range(4):
            c.observe("syncsgd", 0.5 * ratio * c._predict_raw("syncsgd"))
    assert t.step() is True and j.step() is True
    _same(j, t)
    assert t.decisions[0].scheme == "syncsgd"


# --------------------------------------------------------- build and cells
def test_resolved_plan_builds_in_the_port():
    """(``build`` joins a one-rank process group when there is none; the
    test leaves none behind for the next module in its process.)"""
    import torch.distributed as dist

    from repro_torch.train import train_step as tts
    _, ta = _archs(False)
    plan, d = tctl.resolve_plan(ta.plan, ta, 4)
    assert d.scheme == "powersgd"
    joined = not dist.is_initialized()
    try:
        setup = tts.build(dataclasses.replace(ta, plan=plan), "cpu")
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
    assert setup.overlap and setup.zero1
    assert setup.agg_cfg.compressor == "powersgd"
    assert setup.arch.plan.adaptive is False


def _fake(seen):
    def run(cmd, env=None, timeout=0):
        seen.append(cmd)
        return {"step_ms": 1.0}, None
    return run


@pytest.mark.parametrize("workers", [2, 4, 8])
def test_adaptive_train_cell_matches_jax(workers, monkeypatch):
    seen_j, seen_t = [], []
    monkeypatch.setattr(jbackend, "run_subprocess_json", _fake(seen_j))
    monkeypatch.setattr(tbackend, "run_subprocess_json", _fake(seen_t))
    kw = dict(workload="tinyllama-1.1b", kind="train", method="adaptive",
              scheme="adaptive", workers=workers, batch=8)
    jr = JMeasured().run(JSpec(**kw))
    tr = MeasuredBackend(device="cpu").run(ExperimentSpec(**kw))
    assert jr.ok and tr.ok
    assert tr.metrics == jr.metrics == {"step_ms": 1.0,
                                        "adaptive_choice": "powersgd"}

    def method(cmd):
        return cmd[cmd.index("--method") + 1]
    assert method(seen_t[0]) == method(seen_j[0]) == "powersgd"


def test_adaptive_train_cell_runs_on_the_cpu(monkeypatch):
    """One worker: no communication to save, so the controller keeps
    syncSGD and the cell measures the uncompressed plan (a real
    ``overlap_bench`` subprocess on the CPU at the reduced size)."""
    seen = []
    monkeypatch.setattr(jbackend, "run_subprocess_json", _fake(seen))
    kw = dict(workload="tinyllama-1.1b", kind="train", method="adaptive",
              scheme="adaptive", workers=1, batch=4)
    jr = JMeasured().run(JSpec(**kw))
    tr = MeasuredBackend(device="cpu", reps=1, warmup=0, worker_args=(
        "--seq", "16", "--reps", "1", "--warmup", "0")).run(
        ExperimentSpec(**kw))
    assert tr.ok, tr.error
    assert tr.metrics["adaptive_choice"] == jr.metrics["adaptive_choice"] \
        == "syncsgd"
    assert tr.metrics["method"] == "none"
