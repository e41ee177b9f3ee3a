"""The port's measured backends' subprocess paths
(``repro_torch.experiments.backend`` and ``.multiproc``), and one real
cell of each on the CPU.

* ``run_subprocess_json`` and ``MultiProcessBackend`` turn every failure
  into an error ``Result`` (the JAX package's ``tests/test_multiproc.py``
  cases on canned ``python -c`` commands): a non-zero exit, garbage or
  truncated stdout, a timeout (which kills every rank's process group,
  grandchildren included), workers that do not split over procs.
* ``_pod_cmds`` gives one argv per rank (``--proc-id 0 .. W-1``), the
  children get no inherited rank environment, and ``_train`` builds the
  ``overlap_bench`` argv (under ``torch.distributed.run`` when
  ``workers > 1``).
* Real cells, started together: a pod of 2 ranks (reduced arch, 2 procs
  x 1 local, gloo) through ``MultiProcessBackend(device="cpu")``, whose
  record feeds the calibration fit (equal to the JAX package's fit of the
  same record at ``rtol 1e-9``) and the headline's ``measured`` block;
  and a one-rank ``_train`` cell whose ``overlap_bench`` record carries
  the JAX bench's keys (``t_serial_us``, ``t_overlap_us``,
  ``t_unfused_us``).
"""
import ast
import concurrent.futures
import dataclasses
import json
import math
import os
import sys
import time

import pytest

from repro.core.perfmodel import calibration as jcal
from repro.experiments.backend import Result as JResult
from repro_torch.core.perfmodel import calibration as tcal
from repro_torch.core.perfmodel import hardware as thw
from repro_torch.experiments import backend as tbackend
from repro_torch.experiments import report
from repro_torch.experiments.backend import (MeasuredBackend,
                                             parse_last_json_line,
                                             run_subprocess_json)
from repro_torch.experiments.multiproc import MultiProcessBackend
from repro_torch.experiments.spec import ExperimentSpec

PY = sys.executable
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# run_subprocess_json: every failure mode is a string, never an exception
# ---------------------------------------------------------------------------
def test_subprocess_json_ok():
    rec, err = run_subprocess_json(
        [PY, "-c", "print('noise'); print('{\"a\": 1}')"])
    assert err is None and rec == {"a": 1}


def test_subprocess_json_nonzero_exit_keeps_stderr():
    rec, err = run_subprocess_json(
        [PY, "-c", "import sys; sys.stderr.write('boom boom'); "
                   "sys.exit(3)"])
    assert rec is None and "rc=3" in err and "boom boom" in err


@pytest.mark.parametrize("out", ["not json at all", '{"a": 1', "[1, 2]"])
def test_subprocess_json_garbage_or_truncated_stdout(out):
    rec, err = run_subprocess_json([PY, "-c", f"print({out!r})"])
    assert rec is None and "bad stdout JSON" in err


def test_subprocess_json_timeout_kills_the_group(tmp_path):
    t0 = time.monotonic()
    rec, err = run_subprocess_json(_sleeper(tmp_path / "g"), timeout=1)
    assert rec is None and "timeout after 1" in err
    assert time.monotonic() - t0 < 30
    assert not _alive(int((tmp_path / "g").read_text()))


def test_parse_last_json_line_contract():
    assert parse_last_json_line("x\n{\"k\": 2}\n") == {"k": 2}
    for bad in ("", "[1, 2]", "{\"k\": "):
        with pytest.raises(ValueError):
            parse_last_json_line(bad)


# ---------------------------------------------------------------------------
# MultiProcessBackend failure paths through the _pod_cmds seam
# ---------------------------------------------------------------------------
def pod_spec(**kw):
    kw.setdefault("comm", "hierarchical:data")
    kw.setdefault("method", "none")
    kw.setdefault("workers", 4)
    return ExperimentSpec(workload="tinyllama-1.1b", batch=8,
                          hardware="cpu-host", kind="train", overlap=True,
                          procs=2, **kw)


class CannedPod(MultiProcessBackend):
    """_pod_cmds replaced by canned ``python -c`` rank commands."""

    def __init__(self, cmds, **kw):
        super().__init__(device="cpu", **kw)
        self._canned = cmds

    def _pod_cmds(self, spec, port):
        return self._canned


def _sleeper(pid_file):
    """A command that starts a grandchild, writes its pid to
    ``pid_file`` and sleeps."""
    code = ("import subprocess, sys, time; p = subprocess.Popen("
            "[sys.executable, '-c', 'import time; time.sleep(60)']); "
            "open(sys.argv[1], 'w').write(str(p.pid)); time.sleep(60)")
    return [PY, "-c", code, str(pid_file)]


def _alive(pid, wait_s=10.0):
    """Is ``pid`` running (not gone, not a zombie) after up to wait_s?"""
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except FileNotFoundError:
            return False
        if state in ("Z", "X"):
            return False
        time.sleep(0.1)
    return True


def test_pod_member_nonzero_exit_is_error_result():
    r = CannedPod([[PY, "-c", "print('{}')"],
                   [PY, "-c", "import sys; sys.stderr.write('gloo died'); "
                              "sys.exit(7)"]]).run(pod_spec())
    assert not r.ok and r.status == "error"
    assert "pod_worker 1" in r.error and "rc=7" in r.error
    assert "gloo died" in r.error


def test_pod_garbage_stdout_is_error_result():
    r = CannedPod([[PY, "-c", "print('###')"],
                   [PY, "-c", "pass"]]).run(pod_spec())
    assert not r.ok and "bad stdout JSON" in r.error


def test_pod_timeout_kills_every_rank_and_is_error_result(tmp_path):
    files = [tmp_path / f"r{i}" for i in range(3)]
    t0 = time.monotonic()
    r = CannedPod([[PY, "-c", "print('{}')"]]
                  + [_sleeper(f) for f in files[1:]]
                  + [[PY, "-c", "import time; time.sleep(60)"]],
                  pod_timeout=2).run(pod_spec())
    assert not r.ok and "timeout after 2" in r.error
    assert "pod_worker 1" in r.error
    assert time.monotonic() - t0 < 30
    for f in files[1:]:
        assert not _alive(int(f.read_text()))


def test_pod_success_path_with_canned_record():
    rec = dict(procs=2, workers=4, t_serial_us=1.0)
    r = CannedPod([[PY, "-c", f"print('{json.dumps(rec)}')"],
                   [PY, "-c", "pass"]]).run(pod_spec())
    assert r.ok and r.metrics == rec and r.backend == "multiproc"


def test_pod_ranks_inherit_no_rank_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.setenv(k, "7")
    code = ("import json, os; print(json.dumps({k: os.environ.get(k) for k "
            "in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE', "
            "'MASTER_ADDR', 'MASTER_PORT', 'PYTHONPATH', "
            "'OMP_NUM_THREADS')}))")
    r = CannedPod([[PY, "-c", code]]).run(pod_spec())
    assert r.ok, r.error
    pythonpath = r.metrics.pop("PYTHONPATH")
    assert pythonpath.split(os.pathsep)[0] == os.path.join(ROOT, "src")
    assert r.metrics.pop("OMP_NUM_THREADS") is not None
    assert set(r.metrics.values()) == {None}


@pytest.mark.parametrize("workers", [5, 1])
def test_pod_workers_not_splitting_over_procs_is_error_result(workers):
    r = MultiProcessBackend(device="cpu").run(pod_spec(workers=workers))
    assert not r.ok and "does not split" in r.error


def test_pod_cmds_one_argv_per_rank():
    b = MultiProcessBackend(reps=3, warmup=1, device="cpu",
                            worker_args=("--seq", "32"))
    cmds = b._pod_cmds(pod_spec(method="syncsgd"), port=12345)
    assert len(cmds) == 4
    assert [c[c.index("--proc-id") + 1] for c in cmds] == ["0", "1", "2",
                                                           "3"]
    for cmd in cmds:
        assert cmd[:3] == [PY, "-m", "repro_torch.train.pod_worker"]
        flag = {f: cmd[cmd.index(f) + 1] for f in (
            "--procs", "--local-devices", "--coordinator", "--device",
            "--method", "--comm", "--reps", "--warmup", "--batch")}
        assert flag == {"--procs": "2", "--local-devices": "2",
                        "--coordinator": "127.0.0.1:12345",
                        "--device": "cpu", "--method": "none",
                        "--comm": "hierarchical:data", "--reps": "3",
                        "--warmup": "1", "--batch": "8"}
        assert "--json" in cmd and cmd[-2:] == ["--seq", "32"]
    live = b._pod_cmds(pod_spec(method="live:powersgd:rank=8", zero1=True,
                                comm="auto", workers=2,
                                overrides=(("compress_axes", "all"),)),
                       port=1)[1]
    assert len(b._pod_cmds(pod_spec(workers=2), port=1)) == 2
    assert live[live.index("--method") + 1] == "powersgd"
    assert "--comm" not in live and "--zero1" in live
    plans = [live[i + 1] for i, a in enumerate(live) if a == "--plan"]
    assert plans == ["powersgd_rank=8", "compress_axes=all"]
    r = b.run(pod_spec(method="adaptive"))
    assert r.status == "error" and "controller" in r.error


def test_non_pod_spec_falls_through_to_measured():
    r = MultiProcessBackend(device="cpu").run(
        ExperimentSpec(workload="tinyllama-1.1b", method="none",
                       kind="measured", workers=4, batch=8,
                       hardware="cpu-host"))
    assert r.backend == "multiproc" and "not a live method" in r.error


def test_train_cell_argv(monkeypatch):
    seen = []

    def fake(cmd, env=None, timeout=0):
        seen.append(cmd)
        return {"ok": 1}, None
    monkeypatch.setattr(tbackend, "run_subprocess_json", fake)
    b = MeasuredBackend(device="cpu", worker_args=("--full-size",))
    for workers in (4, 1):
        r = b.run(ExperimentSpec(workload="tinyllama-1.1b",
                                 method="live:qsgd:bits=4", kind="train",
                                 workers=workers, batch=8, accum=2,
                                 comm="allreduce", zero1=True))
        assert r.ok and r.metrics == {"ok": 1}
    multi, one = seen
    assert multi[:7] == [PY, "-m", "torch.distributed.run", "--standalone",
                         "--nproc-per-node", "4", "-m"]
    assert one[:3] == [PY, "-m", "repro_torch.train.overlap_bench"]
    assert multi[7:] == one[2:]
    assert one[3:] == ["--arch", "tinyllama-1.1b", "--device", "cpu",
                       "--method", "qsgd", "--batch", "8", "--json",
                       "--plan", "qsgd_bits=4", "--zero1", "--accum", "2",
                       "--comm", "allreduce", "--full-size"]


# ---------------------------------------------------------------------------
# real cells on the CPU: a 2-rank pod and a one-rank train cell, together
# ---------------------------------------------------------------------------
POD_SPEC = ExperimentSpec(workload="tinyllama-1.1b", method="none",
                          workers=2, procs=2, batch=8, hardware="cpu-host",
                          kind="train", overlap=True, comm="allreduce",
                          variant="pod-ring-p2")
TRAIN_SPEC = ExperimentSpec(workload="tinyllama-1.1b", method="none",
                            workers=1, batch=4, kind="train", zero1=True)


@pytest.fixture(scope="module")
def cells():
    pod = MultiProcessBackend(reps=2, warmup=1, device="cpu",
                              pod_timeout=600, worker_args=("--seq", "32"))
    train = MeasuredBackend(device="cpu", subprocess_timeout=600,
                            worker_args=("--keep-data-axis", "--seq", "32",
                                         "--bucket-mb", "0.125", "--reps",
                                         "2", "--warmup", "1"))
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = {"pod": ex.submit(pod.run, POD_SPEC),
                "train": ex.submit(train.run, TRAIN_SPEC)}
        return {k: f.result() for k, f in futs.items()}


def test_pod_cell_runs_on_the_cpu(cells):
    r = cells["pod"]
    assert r.ok, r.error
    m = r.metrics
    assert (m["procs"], m["workers"], m["local_devices"]) == (2, 2, 1)
    assert m["mesh_shape"] == [2, 1] and m["device"] == "cpu"
    assert m["comm"] == "allreduce" and m["grad_bytes"] > 0
    assert m["params_identical"] and m["serial_equals_overlap"]
    assert m["t_serial_us"] > 0 and m["t_compute_us"] > 0
    assert all(math.isfinite(x) for v in m["losses"].values() for x in v)


def test_pod_cell_feeds_the_fit_and_the_headline(cells):
    r = cells["pod"]
    fit = tcal.calibrate_from_results([r], base_hw=thw.H100)
    jfit = jcal.calibrate_from_results(
        [JResult.from_json(json.loads(json.dumps(r.to_json())))],
        base_hw=jcal.Hardware(**dataclasses.asdict(thw.H100)))
    assert fit.n_obs == jfit.n_obs == 1
    for f in ("alpha", "net_bw", "dcn_bw"):
        assert math.isclose(getattr(fit.hardware, f),
                            getattr(jfit.hardware, f), rel_tol=1e-9)
    assert math.isclose(fit.rows[0]["model_rel_err"],
                        jfit.rows[0]["model_rel_err"], rel_tol=1e-9,
                        abs_tol=1e-12)
    # one ring cell identifies neither tier's split: net_bw stays H100's
    assert fit.hardware.net_bw == thw.H100.net_bw
    h = report.headline(tcal.attach_model_error([r], fit))
    (cell,) = h["measured"]["cells"]
    assert cell["setup"] == POD_SPEC.label() and cell["comm"] == "allreduce"
    assert cell["t_measured_ms"] == round(r.metrics["t_serial_us"] / 1e3, 3)


def _jax_bench_keys():
    """The keys of the JAX overlap_bench's record, read from its source."""
    src = open(os.path.join(ROOT, "src", "repro", "train",
                            "overlap_bench.py")).read()
    keys = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "rec":
            keys |= {kw.arg for kw in node.value.keywords}
        if isinstance(node, ast.Subscript) and \
                getattr(node.value, "id", None) == "rec" and \
                isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


def test_train_cell_record_has_the_jax_bench_keys(cells):
    r = cells["train"]
    assert r.ok, r.error
    keys = _jax_bench_keys()
    assert {"t_serial_us", "t_overlap_us", "t_unfused_us"} <= keys
    assert keys <= set(r.metrics)
    m = r.metrics
    assert m["device"] == "cpu" and m["workers"] == 1 and m["zero1"]
    for k in ("serial", "overlap", "unfused"):
        assert m[f"t_{k}_us"] == pytest.approx(m["step_ms"][k] * 1e3,
                                               rel=1e-12)
