"""The port's performance model (``repro_torch.core.perfmodel``) and the
compressors' accounting against the JAX package's, on the same inputs.

Both packages run the same float arithmetic in the same order on the same
Python floats, so every time, byte count and fitted constant is expected
to agree exactly; the tolerance stated is ``rel 1e-12`` (``rtol 1e-9``
for the least-squares fit, whose LAPACK call may order its sums
differently).  The compressors' wire accounting is compared as exact ints
and floats.

The inputs are a grid drawn with numpy from a fixed seed: workloads,
worker counts, hardware points (the presets both packages share, the
paper's calibrated point, and random ones), comm plans and compression
specs.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core.compression import base as jbase
from repro.core.perfmodel import calibration as jcal
from repro.core.perfmodel import costs as jcosts
from repro.core.perfmodel import hardware as jhw
from repro.core.perfmodel import model as jpm
from repro.core.perfmodel import whatif as jwhatif
from repro.experiments import report as jreport
from repro.experiments.backend import Result as JResult
from repro.experiments.spec import ExperimentSpec as JSpec
from repro_torch.core.compression import base as tbase
from repro_torch.core.perfmodel import calibration as tcal
from repro_torch.core.perfmodel import costs as tcosts
from repro_torch.core.perfmodel import hardware as thw
from repro_torch.core.perfmodel import model as tpm
from repro_torch.core.perfmodel import whatif as twhatif
from repro_torch.experiments import report as treport
from repro_torch.experiments.backend import Result as TResult

REL = 1e-12
RNG = np.random.default_rng(18)
PS = (1, 2, 3, 4, 7, 8, 16, 64, 96, 128)
PLANS = ("auto", "allreduce", "reduce_scatter_allgather",
         "reduce_to_owner_broadcast", "gather_all", "hierarchical",
         "hierarchical:data")
SIZES = [float(x) for x in RNG.uniform(1e3, 5e8, 6)] + [0.0, 1.0]


def close(a, b, rel=REL):
    """Equal within ``rel``, recursively through lists, tuples and dicts
    (non-float leaves exactly)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(close(a[k], b[k], rel) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y, rel)
                                        for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, (int, float)):
        if math.isinf(a) or math.isnan(a):
            return a == b or (math.isnan(a) and math.isnan(b))
        return math.isclose(a, b, rel_tol=rel, abs_tol=0.0)
    return a == b


def to_port(obj):
    """A JAX perf-model dataclass as the port's, field for field."""
    cls = {jhw.Hardware: thw.Hardware, jpm.Workload: tpm.Workload,
           jpm.CompressionSpec: tpm.CompressionSpec,
           jcal.PodObservation: tcal.PodObservation}[type(obj)]
    return cls(**dataclasses.asdict(obj))


def rand_hw(i):
    return jhw.Hardware(
        name=f"rand{i}", peak_flops=float(RNG.uniform(1e12, 1e15)),
        hbm_bw=float(RNG.uniform(1e11, 4e12)),
        net_bw=float(RNG.uniform(1e8, 5e11)),
        alpha=float(RNG.uniform(1e-7, 1e-4)),
        allgather_congestion=float(RNG.uniform(1.0, 2.5)),
        dcn_bw=float(RNG.choice([0.0, RNG.uniform(1e8, 5e10)])))


HWS = [jhw.V100_EC2, jhw.CPU_HOST, jcal.PAPER_HW] + [rand_hw(i)
                                                     for i in range(3)]
WORKLOADS = list(jcal.WORKLOADS.values()) + [
    jpm.Workload(f"w{i}", float(RNG.uniform(1e6, 2e9)),
                 float(RNG.uniform(1e-3, 1.0)), float(RNG.uniform(0, 0.1)))
    for i in range(3)]
SPECS = [jcal.paper_spec(m, jcal.BERT) for m in jcal.TABLE2_RATIOS] + [
    jpm.CompressionSpec(f"s{i}", float(RNG.uniform(0, 0.2)),
                        tuple(float(x) for x in RNG.uniform(1e3, 1e8, i + 1)),
                        bool(i % 2))
    for i in range(3)]


# ---------------------------------------------------------------- presets
def test_shared_presets_equal_the_jax_packages():
    assert to_port(jhw.V100_EC2) == thw.V100_EC2
    assert to_port(jhw.CPU_HOST) == thw.CPU_HOST
    assert to_port(jcal.PAPER_HW) == tcal.PAPER_HW
    assert set(thw.PRESETS) == {"v100-ec2-10gbps", "cpu-host", "h100"}


def test_h100_preset_is_the_data_sheet():
    h = thw.H100
    assert (h.peak_flops, h.hbm_bw, h.net_bw, h.dcn_bw) == (
        989e12, 3.35e12, 450e9, 50e9)
    assert h.dcn_bw < h.net_bw and h.allgather_congestion == 1.0


def test_calibration_tables_equal_the_jax_packages():
    for name in ("RESNET50_BYTES", "RESNET101_BYTES", "BERT_BYTES",
                 "TABLE2_ENCODE_DECODE_MS", "TABLE2_RATIOS",
                 "T_COMP_RESNET50", "T_COMP_RESNET101", "T_COMP_BERT",
                 "LAUNCH_OVERHEAD", "ANCHORS"):
        assert getattr(tcal, name) == getattr(jcal, name), name
    assert {k: to_port(w) for k, w in jcal.WORKLOADS.items()} \
        == tcal.WORKLOADS


# ---------------------------------------------------------------- costs
@pytest.mark.parametrize("name", sorted(jcosts.COLLECTIVES))
def test_collectives_equal_the_jax_packages(name):
    jf, tf = jcosts.COLLECTIVES[name], tcosts.COLLECTIVES[name]
    for n in SIZES:
        for p in PS:
            for hw in HWS:
                assert close(tf(n, p, hw.net_bw, hw.alpha),
                             jf(n, p, hw.net_bw, hw.alpha)), (n, p, hw)


def test_hierarchical_payload_and_plan_collectives():
    for n in SIZES:
        for p in PS:
            for hw in HWS:
                for p_intra in (1, 2, 4, 5):
                    assert close(
                        tcosts.hierarchical_all_reduce(
                            n, p, hw.net_bw, hw.alpha, p_intra, hw.dcn_bw),
                        jcosts.hierarchical_all_reduce(
                            n, p, hw.net_bw, hw.alpha, p_intra, hw.dcn_bw))
                for assoc in (True, False):
                    args = (assoc, n, p, hw.net_bw, hw.alpha,
                            hw.allgather_congestion)
                    assert close(tcosts.payload_collective(*args),
                                 jcosts.payload_collective(*args))
                    for plan in PLANS:
                        kw = dict(congestion=hw.allgather_congestion,
                                  p_intra=2, dcn_bw=hw.dcn_bw)
                        outs = []
                        for f in (tcosts.plan_collective,
                                  jcosts.plan_collective):
                            try:
                                outs.append(f(plan, assoc, n, p, hw.net_bw,
                                              hw.alpha, **kw))
                            except ValueError as e:   # CommPlanError
                                outs.append(type(e).__name__)
                        assert close(outs[0], outs[1]), (plan, assoc)


# ---------------------------------------------------------------- model
def _both(fn_name, *args, **kw):
    """``fn_name`` of both models on the same arguments (JAX objects
    converted for the port); an exception is compared by its type."""
    out = []
    for mod, conv in ((tpm, to_port), (jpm, lambda x: x)):
        a = [conv(x) if dataclasses.is_dataclass(x) else x for x in args]
        try:
            r = getattr(mod, fn_name)(*a, **kw)
        except ValueError as e:
            r = type(e).__name__
        out.append(dataclasses.asdict(r) if dataclasses.is_dataclass(r)
                   else r)
    return out


@pytest.mark.parametrize("fn_name", [
    "sync_sgd_time", "sync_sgd_serial_time", "gap_to_linear",
    "required_compression"])
def test_baseline_times_equal_the_jax_packages(fn_name):
    for w in WORKLOADS:
        for p in PS:
            for hw in HWS:
                t, j = _both(fn_name, w, p, hw)
                assert close(t, j), (fn_name, w, p, hw)


@pytest.mark.parametrize("fn_name", [
    "sync_sgd_plan_time", "sync_sgd_serial_plan_time", "zero1_gather_time",
    "grad_exchange_bytes", "zero1_exchange_bytes"])
def test_plan_times_equal_the_jax_packages(fn_name):
    for w in WORKLOADS:
        for p in PS:
            for hw in HWS:
                for comm in PLANS:
                    t, j = _both(fn_name, w, p, hw, comm=comm)
                    assert close(t, j), (fn_name, w, p, hw, comm)


@pytest.mark.parametrize("fn_name", [
    "compressed_time", "speedup_vs_sync", "compressed_plan_time",
    "crossover_bandwidth"])
def test_compressed_times_equal_the_jax_packages(fn_name):
    plans = PLANS if fn_name == "compressed_plan_time" else (None,)
    for w in WORKLOADS[:4]:
        for p in (1, 4, 64):
            for hw in HWS:
                for spec in SPECS:
                    for comm in plans:
                        kw = {} if comm is None else dict(comm=comm)
                        t, j = _both(fn_name, w, p, hw, spec, **kw)
                        assert close(t, j), (fn_name, w, p, hw, spec, comm)


def test_bucket_time_accum_and_linear_equal_the_jax_packages():
    for w in WORKLOADS:
        assert close(*_both("linear_scaling_time", w))
        for accum in (1, 2, 8):
            assert close(*_both("accum_scaled", w, accum))
        for p in (1, 8, 96):
            for hw in HWS[:3]:
                for ratio in (1.0, 4.0, 37.5, 1000.0):
                    assert close(*_both("bucket_compressed_time", w, p, hw,
                                        ratio, 0.01))


def test_compression_spec_properties_equal_the_jax_packages():
    for spec in SPECS:
        t = to_port(spec)
        assert close(t.total_payload, spec.total_payload)
        assert t.associative == spec.associative
        for w in WORKLOADS:
            assert close(t.compression_ratio(w.model_bytes),
                         spec.compression_ratio(w.model_bytes))


# ---------------------------------------------------------------- calibration
def test_paper_specs_and_scaling_equal_the_jax_packages():
    for w in jcal.WORKLOADS.values():
        for m in jcal.TABLE2_RATIOS:
            assert close(dataclasses.asdict(tcal.paper_spec(m, to_port(w))),
                         dataclasses.asdict(jcal.paper_spec(m, w)))
            assert close(tcal.encode_decode_time(m, to_port(w)),
                         jcal.encode_decode_time(m, w))
        for b in (4, 16, 64, 256):
            assert close(dataclasses.asdict(tcal.batch_scaled(to_port(w), b)),
                         dataclasses.asdict(jcal.batch_scaled(w, b)))


def test_pod_prediction_and_features_equal_the_jax_packages():
    for comm in ("allreduce", "hierarchical"):
        for p, p_intra in ((1, 1), (2, 1), (4, 2), (8, 4), (6, 3)):
            o = jcal.PodObservation("x", "h", "w", p, p_intra, comm,
                                    float(RNG.uniform(1e5, 1e9)), 1.0, 0.1)
            assert close(tcal._pod_features(to_port(o)),
                         jcal._pod_features(o))
            for hw in HWS:
                assert close(tcal.predict_pod_step(to_port(o), to_port(hw)),
                             jcal.predict_pod_step(o, hw))
    for comm in ("auto", "allreduce", "reduce_scatter_allgather",
                 "hierarchical", "hierarchical:data"):
        assert tcal._resolve_pod_comm(comm) == jcal._resolve_pod_comm(comm)
    with pytest.raises(ValueError):
        tcal._resolve_pod_comm("gather_all")


TRUE_HW = dataclasses.replace(jhw.CPU_HOST, alpha=80e-6, net_bw=3e9,
                              dcn_bw=4e8)


def pod_records(hw=TRUE_HW, noise=0.0):
    """(JAX results, port results) of synthetic pod cells whose step
    times the JAX model generates on ``hw`` (times ``1 + noise * u``,
    ``u`` uniform in [-1, 1]): the same records in both packages' types."""
    jres = []
    for comm, procs, local in (("hierarchical:data", 2, 2),
                               ("allreduce", 2, 2), ("allreduce", 2, 1),
                               ("hierarchical:data", 4, 2)):
        spec = JSpec(workload="tinyllama-1.1b", method="none",
                     workers=procs * local, batch=8, hardware="cpu-host",
                     kind="train", overlap=True, procs=procs, comm=comm)
        grad_bytes, t_compute = 1706496, 0.02
        o = jcal.PodObservation(
            spec.label(), spec.spec_hash(), "x", procs * local, local,
            jcal._resolve_pod_comm(comm), float(grad_bytes), 0.0, t_compute)
        t = jcal.predict_pod_step(o, hw) * (1 + noise * RNG.uniform(-1, 1))
        jres.append(JResult(spec, "multiproc", metrics=dict(
            procs=procs, workers=procs * local, local_devices=local,
            comm=comm, grad_bytes=grad_bytes, t_serial_us=t * 1e6,
            t_compute_us=t_compute * 1e6)))
    return jres, [TResult.from_json(r.to_json()) for r in jres]


def _fit_equal(tfit, jfit, rtol=1e-9):
    for f in ("alpha", "net_bw", "dcn_bw"):
        assert math.isclose(getattr(tfit.hardware, f),
                            getattr(jfit.hardware, f), rel_tol=rtol), f
    assert tfit.n_obs == jfit.n_obs
    assert len(tfit.rows) == len(jfit.rows)
    for a, b in zip(tfit.rows, jfit.rows):
        assert a.keys() == b.keys()
        assert {k: a[k] for k in ("label", "spec_hash", "comm", "p",
                                  "p_intra")} == \
            {k: b[k] for k in ("label", "spec_hash", "comm", "p", "p_intra")}
        for k in ("t_measured_s", "t_model_s"):
            assert math.isclose(a[k], b[k], rel_tol=rtol)
        assert math.isclose(a["model_rel_err"], b["model_rel_err"],
                            rel_tol=rtol, abs_tol=1e-12)


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_calibration_fit_equals_the_jax_packages(noise):
    jres, tres = pod_records(noise=noise)
    for base in (None, jhw.CPU_HOST, jhw.V100_EC2):
        jfit = jcal.calibrate_from_results(jres, base_hw=base)
        tfit = tcal.calibrate_from_results(
            tres, base_hw=None if base is None else to_port(base))
        _fit_equal(tfit, jfit)
    tfit = tcal.calibrate_from_results(tres, base_hw=thw.H100)
    assert tfit.hardware.name == "h100-fit"


def test_calibration_zero_residual_order_invariant_and_attached():
    _, tres = pod_records()
    fit = tcal.calibrate_from_results(tres)
    assert fit.max_abs_rel_err < 1e-9
    for f in ("alpha", "net_bw", "dcn_bw"):
        assert math.isclose(getattr(fit.hardware, f), getattr(TRUE_HW, f),
                            rel_tol=1e-6)
    back = tcal.calibrate_from_results(list(reversed(tres)))
    assert back.hardware == fit.hardware and back.rows == fit.rows
    out = tcal.attach_model_error(tres, fit)
    jres = [JResult.from_json(r.to_json()) for r in out]
    assert close(treport.headline(out), jreport.headline(jres))
    assert treport.headline(out)["measured"]["max_abs_rel_err"] == 0.0
    with pytest.raises(ValueError):
        tcal.calibrate_from_results([])


# ---------------------------------------------------------------- what-if
def test_whatif_sweeps_equal_the_jax_packages():
    w, hw = jcal.RESNET101, jcal.PAPER_HW
    spec = jcal.paper_spec("powersgd-r4", w)
    tw, thwp, tspec = to_port(w), to_port(hw), to_port(spec)
    cases = [
        ("bandwidth_sweep", (w, 64, hw, spec), (tw, 64, thwp, tspec)),
        ("batch_size_sweep",
         (w, 64, hw, lambda wb: jcal.paper_spec("signsgd", wb)),
         (tw, 64, thwp, lambda wb: tcal.paper_spec("signsgd", wb))),
        ("required_compression_sweep", (w, 96, hw), (tw, 96, thwp)),
        ("compute_speedup_sweep", (w, 32, hw, spec), (tw, 32, thwp, tspec)),
        ("encode_tradeoff_sweep", (w, 16, hw, spec), (tw, 16, thwp, tspec)),
        ("scaling_curve", (w, hw, spec), (tw, thwp, tspec)),
        ("scaling_curve", (w, hw, None), (tw, thwp, None)),
    ]
    for name, jargs, targs in cases:
        assert close(getattr(twhatif, name)(*targs),
                     getattr(jwhatif, name)(*jargs)), name


def test_choose_policy_equals_the_jax_packages():
    for w in jcal.WORKLOADS.values():
        for p in (4, 16, 96):
            for gbps in (1, 10, 100):
                hw = jcal.PAPER_HW.with_net(gbps)
                jspecs = [jcal.paper_spec(m, w) for m in jcal.TABLE2_RATIOS]
                assert twhatif.choose_policy(
                    w.model_bytes, w.t_comp, p, to_port(hw),
                    [to_port(s) for s in jspecs]) == jwhatif.choose_policy(
                    w.model_bytes, w.t_comp, p, hw, jspecs)


# ---------------------------------------------------------------- accounting
LIVE = [("none", {}), ("powersgd", {}), ("powersgd", {"rank": 8}),
        ("signsgd", {}), ("qsgd", {}), ("qsgd", {"bits": 4}),
        ("terngrad", {}), ("randomk", {}), ("randomk", {"frac": 0.02}),
        ("mstopk", {}), ("mstopk", {"frac": 0.001}),
        ("ef:signsgd", {}), ("ef:qsgd", {}), ("ef:terngrad", {}),
        ("ef:randomk", {}), ("ef:mstopk", {})]
N_ELEMS = (5_000, 70_001, 13_107_200)


@pytest.mark.parametrize("name,kw", LIVE,
                         ids=[f"{n}{kw}" for n, kw in LIVE])
def test_compressor_accounting_equals_the_jax_packages(name, kw):
    t, j = tbase.make(name, **kw), jbase.make(name, **kw)
    assert t.name == j.name and t.registry_name == j.registry_name
    assert t.all_reduce_compatible == j.all_reduce_compatible
    for n in N_ELEMS:
        assert t.encode_decode_flops(n) == j.encode_decode_flops(n)
        for itemsize in (4, 2):
            assert t.wire_round_bytes(n, itemsize) == \
                j.wire_round_bytes(n, itemsize)
            assert t.compressed_bytes(n, itemsize) == \
                j.compressed_bytes(n, itemsize)
            assert t.compression_ratio(n, itemsize) == \
                j.compression_ratio(n, itemsize)
            ts = tpm.CompressionSpec.for_compressor(t, n, 1e-3, itemsize)
            js = jpm.CompressionSpec.for_compressor(j, n, 1e-3, itemsize)
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)
            assert dataclasses.asdict(tcal.spec_from_compressor(
                t, n, 2e-3, itemsize)) == dataclasses.asdict(
                jcal.spec_from_compressor(j, n, 2e-3, itemsize))
