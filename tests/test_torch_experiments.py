"""The port's sweep API (``repro_torch.experiments``) and decision rule
(``repro_torch.adaptive.policy``) against the JAX package's.

* ``ExperimentSpec``: ``to_json`` and ``spec_hash`` equal for every spec
  of the paper matrix (216), the adaptive matrix (36), the comm-expanded
  matrix and a spec with every field set; a ``ResultStore`` written by
  either package loads in the other.
* ``AnalyticBackend``: the metrics of every matrix cell, and of a grid of
  comm plans, ZeRO-1, accumulation, the overlap knob, live methods with
  and without ``error_feedback``, inline fields and hardware presets,
  equal to the JAX package's at ``rel 1e-12`` (the same float arithmetic:
  exact equality is expected); ``headline``: 15/216 wins, every winner
  ``bert-base/powersgd-*`` on ``allreduce``, adaptive 9/36 wins and 36/36
  ties or better, as in the JAX package.
* ``policy.decide`` equal on the paper matrix.
* ``MeasuredBackend._live`` on the CPU at small n, one cell per scheme:
  the JAX backend's keys, and its ``wire_bytes``, ``rounds`` and ``ratio``
  (the times are each package's own).
"""
import dataclasses
import json
import math

import pytest
import torch

from repro.adaptive import policy as jpolicy
from repro.core.perfmodel import calibration as jcal
from repro.core.perfmodel import hardware as jhw
from repro.experiments import AnalyticBackend as JAnalytic
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import Grid as JGrid
from repro.experiments import MeasuredBackend as JMeasured
from repro.experiments import Result as JResult
from repro.experiments import ResultStore as JStore
from repro.experiments import Runner as JRunner
from repro.experiments import report as jreport
from repro_torch.adaptive import policy as tpolicy
from repro_torch.core.perfmodel import calibration as tcal
from repro_torch.core.perfmodel import hardware as thw
from repro_torch.core.perfmodel import model as tpm
from repro_torch.core.perfmodel import whatif as twhatif
from repro_torch.experiments import (AnalyticBackend, ExperimentSpec, Grid,
                                     MeasuredBackend, Result, ResultStore,
                                     Runner, hardware_fields, headline,
                                     headline_rows, headline_verdicts,
                                     method_fields, workload_fields)
from repro_torch.experiments import backend as tbackend

REL = 1e-12

#: every field set (none left at its default)
FULL = dict(workload="resnet101", method="live:qsgd:bits=4", workers=48,
            batch=32, hardware="custom", compress_axes="all",
            kind="measured", overlap=False, zero1=True, accum=2,
            comm="gather_all", scheme="static", error_feedback=True,
            procs=2, model_bytes=123456789.0, t_comp_s=0.321,
            net_bw=1.25e9, alpha=1e-5, congestion=1.5, peak_flops=1e14,
            t_encode_decode_s=0.004, payload_bytes=(1e6, 2.5e6),
            associative=False, n_elements=4096, shape="train_4k",
            mesh="multi", variant="v", overrides=(
                ("bucket_mb", 0.25), ("mesh_shape", (2, 2))))


def matrix_pairs():
    """(port spec, JAX spec) of every matrix cell, in order."""
    t = list(Grid.paper_matrix()) + list(Grid.adaptive_matrix()) \
        + list(Grid.paper_matrix(comm=("auto", "gather_all")))
    j = list(JGrid.paper_matrix()) + list(JGrid.adaptive_matrix()) \
        + list(JGrid.paper_matrix(comm=("auto", "gather_all")))
    return list(zip(t, j))


def close(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, (int, float)):
        if math.isinf(a):
            return a == b
        return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)
    return a == b


# ------------------------------------------------------------ specs
def test_matrix_specs_json_and_hash_equal_the_jax_packages():
    pairs = matrix_pairs()
    assert len(pairs) == 216 + 36 + 432
    for t, j in pairs:
        assert t.to_json() == j.to_json()
        assert t.spec_hash() == j.spec_hash() and t.label() == j.label()
    assert len({t.spec_hash() for t, _ in pairs[:252]}) == 252


def test_full_spec_round_trips_between_the_packages():
    t, j = ExperimentSpec(**FULL), JSpec(**FULL)
    assert t.to_json() == j.to_json() and t.spec_hash() == j.spec_hash()
    blob = json.loads(json.dumps(t.to_json()))
    assert JSpec.from_json(blob) == j and ExperimentSpec.from_json(blob) == t
    assert ExperimentSpec(workload="resnet50", method="signsgd",
                          workers=8).spec_hash() == "81dcb7adce767830"


def test_field_builders_equal_the_jax_packages():
    from repro.experiments import spec as jspec
    w, hw = jcal.RESNET101, jcal.PAPER_HW.with_net(3.7)
    cspec = jcal.paper_spec("powersgd-r8", w)
    tw = tpm.Workload(**dataclasses.asdict(w))
    thwp = thw.Hardware(**dataclasses.asdict(hw))
    tc = tpm.CompressionSpec(**dataclasses.asdict(cspec))
    assert workload_fields(tw) == jspec.workload_fields(w)
    assert hardware_fields(thwp) == jspec.hardware_fields(hw)
    assert method_fields(tc) == jspec.method_fields(cspec)


def test_result_stores_load_in_either_package(tmp_path):
    pairs = matrix_pairs()[::37]
    t_rows = Runner(AnalyticBackend(), store=ResultStore(
        str(tmp_path / "port.jsonl"))).run([t for t, _ in pairs])
    j_rows = JRunner(JAnalytic(), store=JStore(
        str(tmp_path / "jax.jsonl"))).run([j for _, j in pairs])
    from_port = JStore(str(tmp_path / "port.jsonl")).load()
    from_jax = ResultStore(str(tmp_path / "jax.jsonl")).load()
    assert set(from_port) == set(from_jax) == {t.spec_hash()
                                               for t, _ in pairs}
    for t, j in zip(t_rows, j_rows):
        h = t.spec.spec_hash()
        assert from_port[h].spec == j.spec and from_jax[h].spec == t.spec
        assert close(from_port[h].metrics, j.metrics)
        assert close(from_jax[h].metrics, t.metrics)
    # a port Runner resumes from the JAX package's store: nothing to run
    class Refuse:
        name = "refuse"

        def run(self, spec):
            raise AssertionError(f"re-ran {spec.label()}")
    again = Runner(Refuse(), store=ResultStore(
        str(tmp_path / "jax.jsonl"))).run([t for t, _ in pairs])
    assert [r.spec for r in again] == [t for t, _ in pairs]


# ------------------------------------------------------------ analytic
def _assert_same_result(t: Result, j: JResult):
    assert t.status == j.status, (t.spec.label(), t.error, j.error)
    if t.ok:
        assert close(t.metrics, j.metrics), t.spec.label()
    else:
        assert t.error.split(":")[0] == j.error.split(":")[0]


def test_analytic_matrix_cells_equal_the_jax_packages():
    pairs = matrix_pairs()
    ts = Runner(AnalyticBackend()).run([t for t, _ in pairs])
    js = JRunner(JAnalytic()).run([j for _, j in pairs])
    for t, j in zip(ts, js):
        _assert_same_result(t, j)


EXTRA_AXES = dict(
    method=["syncsgd", "powersgd-r4", "mstopk-0.01", "signsgd",
            "live:powersgd", "live:powersgd:rank=8", "live:qsgd",
            "live:ef:qsgd", "live:randomk:frac=0.02", "live:terngrad",
            "live:mstopk", "live:signsgd", "adaptive", "nonsense"],
    plan=[dict(comm="auto"), dict(comm="allreduce"),
          dict(comm="gather_all"), dict(comm="hierarchical"),
          dict(comm="reduce_to_owner_broadcast", zero1=True),
          dict(zero1=True), dict(accum=4), dict(overlap=False),
          dict(error_feedback=True)],
    setup=[dict(workload="bert-base", workers=16),
           dict(workload="resnet50", workers=96, batch=16),
           dict(workload="resnet101", workers=4, hardware="v100-ec2-10gbps"),
           dict(workload="resnet101", workers=8, hardware="cpu-host"),
           dict(workload="user", workers=32, model_bytes=2.2e9,
                t_comp_s=0.4, hardware="custom", net_bw=5e10, alpha=2e-6,
                congestion=1.0, peak_flops=9.89e14, n_elements=13_107_200)])


def test_analytic_extra_cells_equal_the_jax_packages():
    base = dict(workload="resnet50")
    t_specs = Grid.over(ExperimentSpec(**base), **EXTRA_AXES).specs()
    j_specs = JGrid.over(JSpec(**base), **EXTRA_AXES).specs()
    assert len(t_specs) == 14 * 9 * 5
    ts = Runner(AnalyticBackend()).run(t_specs)
    js = JRunner(JAnalytic()).run(j_specs)
    for t, j in zip(ts, js):
        assert t.spec.spec_hash() == j.spec.spec_hash()
        _assert_same_result(t, j)
    # the grid is mostly legal (illegal plans and methods are errors)
    assert sum(r.ok for r in ts) == sum(r.ok for r in js) > len(ts) // 2


def test_tpu_v5e_preset_is_an_unknown_preset_in_the_port():
    r = AnalyticBackend().run(ExperimentSpec(
        workload="resnet50", method="signsgd", workers=8,
        hardware="tpu-v5e"))
    assert r.status == "error" and "tpu-v5e" in r.error
    r = AnalyticBackend().run(ExperimentSpec(
        workload="resnet50", method="signsgd", workers=8, hardware="h100"))
    assert r.ok and r.metrics["t_sync_s"] > 0


def test_headline_equals_the_jax_packages():
    t_specs = list(Grid.paper_matrix()) + list(Grid.adaptive_matrix())
    ts = Runner(AnalyticBackend()).run(t_specs)
    js = JRunner(JAnalytic()).run(list(JGrid.paper_matrix())
                                  + list(JGrid.adaptive_matrix()))
    h, hj = headline(ts), jreport.headline(js)
    assert close(h, hj)
    assert (h["setups"], h["wins"], h["errors"]) == (216, 15, 0)
    assert all(w["setup"].startswith("bert-base/powersgd-")
               and w["comm"] == "allreduce" for w in h["winners"])
    a = h["adaptive"]
    assert (a["setups"], a["wins"], a["errors"],
            a["ties_or_beats_static"]) == (36, 9, 0, "36/36")
    assert close(headline_rows(ts), jreport.headline_rows(js))
    assert headline_verdicts(h) == jreport.headline_verdicts(hj)
    assert all(ok for *_, ok in headline_verdicts(h))


def test_runner_resume_and_torn_line(tmp_path):
    path = tmp_path / "results.jsonl"

    class Counting:
        name = "counting"

        def __init__(self):
            self.calls = 0

        def run(self, spec):
            self.calls += 1
            return Result(spec, self.name, status="error"
                          if spec.method == "signsgd" else "ok",
                          metrics={"t_sync_s": 1.0})
    specs = Grid.over(ExperimentSpec(workload="resnet50"),
                      method=["powersgd-r4", "signsgd"],
                      workers=[8, 16]).specs()
    b1, b2 = Counting(), Counting()
    Runner(b1, store=ResultStore(str(path))).run(specs)
    r2 = Runner(b2, store=ResultStore(str(path))).run(specs)
    assert (b1.calls, b2.calls) == (4, 2)      # errors are retried
    assert [r.spec for r in r2] == specs
    with open(path, "a") as f:
        f.write('{"spec_hash": "deadbeef", "spec": {"workl')
    assert set(ResultStore(str(path)).load()) == {s.spec_hash()
                                                  for s in specs}
    assert len(Runner(AnalyticBackend()).run(Grid.over(
        ExperimentSpec(workload="resnet50", method="powersgd-r4"),
        workers=[8, 16]))) == 2


def test_whatif_surfaces_the_backends_error():
    spec = tcal.paper_spec("powersgd-r4", tcal.RESNET50)
    with pytest.raises(RuntimeError, match="analytic backend failed"):
        twhatif.bandwidth_sweep(tcal.RESNET50, 64, tcal.PAPER_HW, spec,
                                gbps=(0,))


# ------------------------------------------------------------ policy
def test_policy_decide_equals_the_jax_packages_on_the_paper_matrix():
    from repro.experiments.spec import PAPER_WORKER_COUNTS
    n = 0
    for name, jw in jcal.WORKLOADS.items():
        tw = tcal.WORKLOADS[name]
        for batch in (16, 64):
            jwb, twb = jcal.batch_scaled(jw, batch), tcal.batch_scaled(
                tw, batch)
            for comm in ("auto", "gather_all", "allreduce"):
                jc = jpolicy.paper_candidates(jwb, comm=comm)
                tc = tpolicy.paper_candidates(twb, comm=comm)
                assert [dataclasses.asdict(c) for c in tc] == \
                    [dataclasses.asdict(c) for c in jc]
                for p in PAPER_WORKER_COUNTS:
                    for margin, extra in ((0.0, 0.0), (0.05, 0.01)):
                        d = tpolicy.decide(twb, p, tcal.PAPER_HW, tc,
                                           margin=margin, t_extra=extra,
                                           comm_base=comm)
                        dj = jpolicy.decide(jwb, p, jcal.PAPER_HW, jc,
                                            margin=margin, t_extra=extra,
                                            comm_base=comm)
                        assert close(dataclasses.asdict(d),
                                     dataclasses.asdict(dj))
                        assert d.is_baseline == dj.is_baseline
                        n += 1
    assert n == 3 * 2 * 3 * 12 * 2
    buckets = [1e6, 2.5e7, 3e5]
    assert [dataclasses.asdict(w) for w in tpolicy.bucket_workloads(
        tcal.BERT, buckets)] == [dataclasses.asdict(w) for w in
                                 jpolicy.bucket_workloads(jcal.BERT,
                                                          buckets)]


# ------------------------------------------------------------ measured
LIVE = ("live:powersgd", "live:signsgd", "live:qsgd", "live:ef:qsgd",
        "live:terngrad", "live:randomk", "live:mstopk")


@pytest.mark.parametrize("method", LIVE)
def test_live_cell_on_the_cpu_matches_the_jax_backends(method):
    spec = ExperimentSpec(workload="bucket", method=method, kind="measured",
                          n_elements=5_000)
    joined = torch.distributed.is_initialized()
    t = MeasuredBackend(reps=1, warmup=1, device="cpu").run(spec)
    j = JMeasured(reps=1, warmup=0).run(JSpec(**spec.to_json() | dict(
        payload_bytes=None, overrides=())))
    assert t.ok and j.ok, (t.error, j.error)
    assert t.metrics.keys() == j.metrics.keys()
    for k in ("method", "n", "wire_bytes", "rounds", "associative",
              "ratio"):
        assert t.metrics[k] == j.metrics[k], k
    assert all(t.metrics[k] > 0 for k in ("t_encode_us", "t_decode_us",
                                          "us_per_call"))
    # a group it made for itself is gone again; a caller's stays
    assert torch.distributed.is_initialized() == joined


def test_measured_backend_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeasuredBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeasuredBackend(device="cuda")
    assert MeasuredBackend(device="cpu").device.type == "cpu"


def test_measured_backend_error_results_name_what_is_missing(monkeypatch):
    b = MeasuredBackend(device="cpu")
    r = b.run(ExperimentSpec(workload="tinyllama-1.1b", kind="dryrun",
                             shape="train_4k", mesh="multi", method="plan"))
    assert r.status == "error" and "launch/dryrun" in r.error
    # an adaptive train cell is no longer missing anything: the controller
    # resolves it (tests/test_torch_adaptive.py holds it against JAX)
    seen = []
    monkeypatch.setattr(tbackend, "run_subprocess_json",
                        lambda cmd, env=None, timeout=0: (
                            seen.append(cmd) or ({}, None)))
    r = b.run(ExperimentSpec(workload="tinyllama-1.1b", kind="train",
                             method="adaptive", scheme="adaptive",
                             workers=4))
    assert r.ok and r.metrics == {"adaptive_choice": "powersgd"}
    assert seen[0][seen[0].index("--method") + 1] == "powersgd"
    r = b.run(ExperimentSpec(workload="tinyllama-1.1b", kind="train",
                             method="live:powersgd:bogus=1"))
    assert r.status == "error" and "no ParallelPlan field" in r.error
    r = b.run(ExperimentSpec(workload="x", kind="measured", method="none"))
    assert r.status == "error" and "not a live method" in r.error


def test_live_method_ids_equal_the_jax_packages():
    from repro.experiments import backend as jbackend
    for m in ("live:powersgd:rank=8", "live:ef:randomk:frac=0.02",
              "live:qsgd:bits=4:error_feedback=true"):
        assert tbackend.parse_live_method(m) == jbackend.parse_live_method(m)
        name, kw = tbackend.parse_live_method(m)
        assert tbackend.live_method_id(name, **kw) == \
            jbackend.live_method_id(name, **kw)
        outs = []
        for mod in (tbackend, jbackend):
            try:
                outs.append(mod.live_plan_args(m))
            except ValueError:                # randomk's frac: no field
                outs.append("ValueError")
        assert outs[0] == outs[1]
        assert tbackend.make_live_compressor(m).name == \
            jbackend.make_live_compressor(m).name
    with pytest.raises(ValueError):
        tbackend.parse_live_method("live:ef")
    assert thw.PRESETS["cpu-host"] == thw.Hardware(
        **dataclasses.asdict(jhw.CPU_HOST))
