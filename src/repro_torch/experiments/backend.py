"""Backends: evaluate one ``ExperimentSpec`` into one ``Result``.
Counterpart of ``repro.experiments.backend``.

Two implementations of the same ``run(spec) -> Result`` contract:

``AnalyticBackend``
    The paper's performance model (``pm.sync_sgd_time`` /
    ``pm.compressed_time``), with workload/hardware/method resolution:
    named paper methods come from the calibration tables, the port's live
    compressors come through ``CompressionSpec.for_compressor`` (wire bytes
    from the encode path run on the ``meta`` device), and inline spec
    fields override everything.  The same floats as the JAX package's.

``MeasuredBackend``
    Times the port on its device (``cuda`` unless the caller asks for
    ``cpu``): the Payload API's phases on a one-rank group
    (``kind="measured"``), and the serial, overlapped and unfused DDP
    step schedules of ``repro_torch.train.overlap_bench`` in a subprocess
    (``kind="train"``); an adaptive train cell measures the plan that
    ``adaptive.controller.resolve_plan`` picks for it and records the
    pick as ``adaptive_choice``.  ``kind="dryrun"`` (the JAX package's
    HLO roofline) has no counterpart here yet: it comes back as
    ``status="error"`` naming what is missing.

Both return the same ``Result`` shape so the ``Runner``/``ResultStore``
and the headline report are backend-agnostic.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Optional, Protocol, runtime_checkable

from repro_torch.experiments.spec import ExperimentSpec

#: default "meaningful speedup" margin for the win verdict: compression
#: must beat optimized syncSGD by >5% to count (the paper counts setups
#: with a *meaningful* end-to-end speedup, not ties).
WIN_MARGIN = 0.05


@dataclasses.dataclass
class Result:
    """One evaluated setup.  JSON-lines friendly (one ``to_json`` per
    ``ResultStore`` row)."""
    spec: ExperimentSpec
    backend: str
    status: str = "ok"          # "ok" | "error" | "missing" | "skipped"
    metrics: dict = dataclasses.field(default_factory=dict)
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def to_json(self) -> dict:
        return dict(spec_hash=self.spec.spec_hash(), spec=self.spec.to_json(),
                    backend=self.backend, status=self.status,
                    metrics=self.metrics, error=self.error)

    @classmethod
    def from_json(cls, d: dict) -> "Result":
        return cls(spec=ExperimentSpec.from_json(d["spec"]),
                   backend=d.get("backend", "?"),
                   status=d.get("status", "ok"),
                   metrics=d.get("metrics", {}), error=d.get("error", ""))


@runtime_checkable
class Backend(Protocol):
    """The backend contract: evaluate one spec.  Implementations must be
    deterministic in the spec (analytic) or honestly measured; they must
    never raise on a bad spec — return ``status="error"`` instead, so a
    sweep survives individual broken cells."""
    name: str

    def run(self, spec: ExperimentSpec) -> Result: ...


# ---------------------------------------------------------------------------
# analytic
# ---------------------------------------------------------------------------
class AnalyticBackend:
    """The paper's performance model as a backend (§4.1 + App. B)."""
    name = "analytic"

    def __init__(self, win_margin: float = WIN_MARGIN):
        self.win_margin = win_margin

    # ---- resolution: spec fields -> perf-model objects ------------------
    def _workload(self, spec: ExperimentSpec):
        from repro_torch.core.perfmodel import calibration as cal
        from repro_torch.core.perfmodel import model as pm
        if spec.model_bytes > 0:
            # inline parameters are final — batch is descriptive only
            return pm.Workload(spec.workload, spec.model_bytes,
                               spec.t_comp_s)
        w = cal.WORKLOADS[spec.workload]
        if spec.batch != 64:
            w = cal.batch_scaled(w, spec.batch)
        return w

    def _hardware(self, spec: ExperimentSpec):
        from repro_torch.core.perfmodel import calibration as cal
        from repro_torch.core.perfmodel.hardware import PRESETS
        if spec.hardware in ("paper", "custom"):
            hw = cal.PAPER_HW
        else:
            hw = PRESETS[spec.hardware]
        repl = {}
        if spec.net_bw is not None:
            repl["net_bw"] = spec.net_bw
        if spec.alpha is not None:
            repl["alpha"] = spec.alpha
        if spec.congestion is not None:
            repl["allgather_congestion"] = spec.congestion
        if spec.peak_flops is not None:
            repl["peak_flops"] = spec.peak_flops
        return dataclasses.replace(hw, **repl) if repl else hw

    def _compression(self, spec: ExperimentSpec, w, hw):
        """Resolve the method to a perf-model ``CompressionSpec``:
        inline fields > paper calibration tables > live compressor
        (payload bytes via ``CompressionSpec.for_compressor``)."""
        from repro_torch.core.perfmodel import calibration as cal
        from repro_torch.core.perfmodel import model as pm
        if spec.payload_bytes is not None:
            return pm.CompressionSpec(
                spec.method,
                spec.t_encode_decode_s or 0.0,
                spec.payload_bytes,
                True if spec.associative is None else spec.associative)
        if spec.method in cal.TABLE2_ENCODE_DECODE_MS:
            cspec = cal.paper_spec(spec.method, w)
            if spec.t_encode_decode_s is not None:
                cspec = dataclasses.replace(
                    cspec, t_encode_decode=spec.t_encode_decode_s)
            return cspec
        if spec.method.startswith("live:"):
            method = spec.method
            if spec.error_feedback:
                # rev-5 EF flag: wrap the live compressor in the residual
                # accumulator (repro_torch.adaptive.feedback) before pricing
                name, kw = parse_live_method(method)
                if not name.startswith("ef:"):
                    method = live_method_id(f"ef:{name}", **kw)
            comp = make_live_compressor(method)
            n = spec.n_elements or int(w.model_bytes // 4)
            t_ed = spec.t_encode_decode_s
            if t_ed is None:
                # analytical FLOP estimate on this spec's hardware (the
                # table-2 pattern: matmul-shaped PowerSGD runs at 40% of
                # the matrix peak, the elementwise schemes at ~5%; the JAX
                # package's constants, so both give the same times)
                eff = 0.4 if "powersgd" in comp.registry_name else 0.05
                t_ed = comp.encode_decode_flops(n) / (hw.peak_flops * eff)
            return pm.CompressionSpec.for_compressor(comp, n, t_ed)
        raise KeyError(f"unresolvable method {spec.method!r}")

    # ---- evaluation ------------------------------------------------------
    def run(self, spec: ExperimentSpec) -> Result:
        from repro_torch.core.perfmodel import model as pm
        try:
            w = pm.accum_scaled(self._workload(spec), spec.accum)
            hw = self._hardware(spec)
            p = spec.workers
            if spec.comm == "reduce_to_owner_broadcast" and not (
                    spec.zero1 and spec.is_baseline):
                # same constraint the runtime enforces: the broadcast leg
                # carries the owner's updated params
                raise ValueError(
                    "comm='reduce_to_owner_broadcast' needs zero1=True "
                    "and an uncompressed baseline method")
            # ZeRO-1's post-update param exchange lands on EVERY leg
            # (baseline and compressed alike — the update is sharded no
            # matter how the gradients arrived).  Under rtob it is the
            # congestion-free broadcast leg.
            t_z1 = pm.zero1_gather_time(w, p, hw, comm=spec.comm) \
                if spec.zero1 else 0.0
            t_overlapped = pm.sync_sgd_plan_time(w, p, hw, spec.comm) \
                + t_z1
            t_serial = pm.sync_sgd_serial_plan_time(w, p, hw, spec.comm) \
                + t_z1
            # the overlap knob picks the baseline the cell competes
            # against: None/True = the paper's optimized overlapped
            # syncSGD (historic behaviour), False = the Fig-2 serial
            # strawman.  Both times are always reported so every matrix
            # cell carries its exposed-comm saving.
            t_sync = t_serial if spec.overlap is False else t_overlapped
            m = dict(t_linear_s=pm.linear_scaling_time(w),
                     t_sync_s=t_sync,
                     t_serial_s=t_serial,
                     overlap_saving=1.0 - t_overlapped / t_serial,
                     gap_s=t_sync - pm.linear_scaling_time(w),
                     required_ratio=pm.required_compression(w, p, hw))
            if spec.comm != "auto":
                # per-plan wire accounting, derived from the same
                # CommPlan the runtime executes (docs/comm_api.md)
                m["comm"] = spec.comm
                m["grad_exchange_bytes"] = pm.grad_exchange_bytes(
                    w, p, hw, spec.comm)
            if spec.zero1:
                m["t_zero1_gather_s"] = t_z1
                m["param_exchange_bytes"] = pm.zero1_exchange_bytes(
                    w, p, hw, comm=spec.comm)
            if spec.is_adaptive:
                # the adaptive controller's cell (repro_torch.adaptive.policy):
                # pick the fastest of {overlapped syncSGD} ∪ the Table-2
                # schemes, so the row wins-or-ties the best static scheme
                # and the baseline by construction
                from repro_torch.adaptive import policy
                d = policy.decide(w, p, hw, policy.paper_candidates(
                    w, comm=spec.comm), t_extra=t_z1, comm_base=spec.comm)
                t = d.t_pred
                m.update(
                    t_method_s=t,
                    speedup=t_sync / t,
                    win=bool(t < t_sync * (1 - self.win_margin)),
                    decision=d.scheme,
                    decision_comm=d.comm,
                    adaptive=True,
                    associative=True)
            elif not spec.is_baseline:
                cspec = self._compression(spec, w, hw)
                t = pm.compressed_plan_time(w, p, hw, cspec, spec.comm) \
                    + t_z1
                m.update(
                    t_method_s=t,
                    speedup=t_sync / t,
                    win=bool(t < t_sync * (1 - self.win_margin)),
                    ratio=cspec.compression_ratio(w.model_bytes),
                    associative=bool(cspec.associative))
            return Result(spec, self.name, metrics=m)
        except Exception as e:  # bad cell must not kill the sweep
            return Result(spec, self.name, status="error",
                          error=f"{type(e).__name__}: {e}")


def coerce_kv(v: str) -> Any:
    """``"8"`` -> 8, ``"0.01"`` -> 0.01, ``"true"`` -> True, else str."""
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return {"true": True, "false": False}.get(v.lower(), v)


def parse_live_method(method: str) -> tuple[str, dict]:
    """``"live:<name>[:k=v...]"`` -> (compressor name, constructor kwargs),
    e.g. ``live:powersgd:rank=8`` or ``live:qsgd:bits=4``.  The
    error-feedback wrapper's prefix nests: ``live:ef:randomk:frac=0.02``
    -> ``("ef:randomk", {"frac": 0.02})``."""
    parts = method.split(":")
    if parts[0] != "live" or len(parts) < 2:
        raise ValueError(f"not a live method id: {method!r}")
    name, rest = parts[1], parts[2:]
    if name == "ef":
        if not rest:
            raise ValueError(f"ef: prefix needs an inner compressor: "
                             f"{method!r}")
        name, rest = f"ef:{rest[0]}", rest[1:]
    kw: dict[str, Any] = {}
    for kv in rest:
        k, _, v = kv.partition("=")
        kw[k] = coerce_kv(v)
    return name, kw


def make_live_compressor(method: str):
    """Parse ``"live:<name>[:k=v...]"`` into a registered compressor."""
    name, kw = parse_live_method(method)
    from repro_torch.core.compression import base as cbase
    return cbase.make(name, **kw)


def live_method_id(name: str, **kw: Any) -> str:
    """Inverse of ``make_live_compressor`` for building specs."""
    return ":".join(["live", name] + [f"{k}={v}" for k, v in
                                      sorted(kw.items())])


# ---------------------------------------------------------------------------
# subprocess plumbing (shared by MeasuredBackend and MultiProcessBackend)
# ---------------------------------------------------------------------------
#: the rank environment a launcher gives a process; never inherited by a
#: child, which would otherwise join (or wait for) the parent's group
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _tail(s, n: int = 800) -> str:
    """Last n chars of possibly-None/bytes subprocess output."""
    if s is None:
        return ""
    if isinstance(s, bytes):
        s = s.decode(errors="replace")
    return s[-n:]


def parse_last_json_line(stdout: str) -> dict:
    """The measured-bench stdout protocol: the LAST non-empty stdout line
    is one JSON object.  Raises ``ValueError`` on empty/garbage/truncated
    output (callers turn that into a first-class error Result)."""
    lines = [ln for ln in (stdout or "").strip().splitlines() if ln.strip()]
    if not lines:
        raise ValueError("no stdout")
    try:
        rec = json.loads(lines[-1])
    except json.JSONDecodeError as e:
        raise ValueError(f"last stdout line is not JSON ({e}): "
                         f"{lines[-1][:200]!r}")
    if not isinstance(rec, dict):
        raise ValueError(f"JSON record is {type(rec).__name__}, not object")
    return rec


def run_processes(cmds: list, env: Optional[dict], timeout: float
                  ) -> tuple[list[tuple[Optional[int], str, str]],
                             Optional[int]]:
    """Start every argv of ``cmds`` at once, each in a session of its own
    with its output in temporary files (a full pipe cannot stall a rank),
    and wait for all of them until ``timeout`` s have passed.  On the
    timeout every process group is killed.  Returns each process's
    ``(returncode, stdout, stderr)`` and the index of the first one still
    running at the deadline (None if all ended)."""
    with tempfile.TemporaryDirectory() as tmp:
        files, procs = [], []
        try:
            for i, cmd in enumerate(cmds):
                out = open(os.path.join(tmp, f"{i}.out"), "w+")
                err = open(os.path.join(tmp, f"{i}.err"), "w+")
                files.append((out, err))
                procs.append(subprocess.Popen(
                    cmd, stdout=out, stderr=err, text=True, env=env,
                    start_new_session=True))
            deadline = time.monotonic() + timeout
            timed_out = None
            for i, p in enumerate(procs):
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    timed_out = i
                    break
        finally:
            for p in procs:       # every group, the ended leaders' too
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
            outs = []
            for out, err in files:
                out.seek(0)
                err.seek(0)
                outs.append((out.read(), err.read()))
                out.close()
                err.close()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)], \
        timed_out


def run_subprocess_json(cmd: list, env: Optional[dict] = None,
                        timeout: float = 1800):
    """Run ``cmd`` and parse its last stdout line as a JSON record.

    Returns ``(record, None)`` on success, ``(None, error_str)`` on ANY
    failure — nonzero exit, garbage/truncated stdout JSON, and timeout
    each come back as a string with the captured stderr tail attached, so
    a sweep never dies mid-flight on one broken subprocess (the Backend
    "never raise" contract).  On a timeout the whole process group is
    killed (a ``torchrun`` and its ranks)."""
    [(rc, out, err)], timed_out = run_processes([cmd], env, timeout)
    if timed_out is not None:
        return None, f"timeout after {timeout:g}s: stderr: {_tail(err)}"
    if rc != 0:
        return None, f"rc={rc}: {_tail(err)}"
    try:
        return parse_last_json_line(out), None
    except ValueError as e:
        return None, f"bad stdout JSON: {e}; stderr: {_tail(err)}"


def live_plan_args(method: str) -> tuple[str, list]:
    """Map a ``live:<name>[:k=v...]`` method id onto the measured-bench
    CLI: the compressor name plus ``--plan field=value`` overrides (live
    kwargs like ``rank=8`` must reach the bench's ParallelPlan or the
    subprocess would silently measure the default-parameter compressor
    under this spec's hash).  Raises ``ValueError`` for kwargs with no
    ParallelPlan field."""
    from repro_torch.core.compression import base as cbase
    name, kw = parse_live_method(method)
    inner = name[3:] if name.startswith("ef:") else name
    field_of = dict(cbase.registry()[inner].plan_fields)
    args: list = []
    for k, v in kw.items():
        if k not in field_of:
            raise ValueError(
                f"live kwarg {k!r} of {method} has no ParallelPlan "
                f"field; mappable: {sorted(field_of)}")
        args += ["--plan", f"{field_of[k]}={v}"]
    return name, args


def repro_pythonpath_env() -> dict:
    """os.environ with the port's ``src`` prepended to PYTHONPATH, so a
    spawned ``python -m repro_torch...`` resolves the same code under
    test, and without an inherited rank environment (``RANK_ENV``,
    ``MASTER_*``), so it joins no group of its parent's."""
    import repro_torch
    env = {k: v for k, v in os.environ.items()
           if k not in RANK_ENV and not k.startswith("MASTER_")}
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


# ---------------------------------------------------------------------------
# measured
# ---------------------------------------------------------------------------
class MeasuredBackend:
    """Measure a spec on the port's own code, on ``device``.

    ``kind="measured"``: per-phase wall times of the Payload API on a
    one-rank group whose ``data`` axis the compressor reduces over (the
    collectives are copies) — encode (``encode_and_reduce``: for
    PowerSGD both rounds and the orthonormalization), decode
    (collective-free by contract) and the full ``aggregate`` — plus the
    derived wire accounting.  The keys are the JAX package's.  On the
    card each phase is ``warmup`` calls, a synchronise, ``reps`` calls
    and a synchronise, timed on the host clock between the two.

    ``kind="train"``: one ``repro_torch.train.overlap_bench --json`` run
    in a subprocess (under ``torch.distributed.run --nproc-per-node
    workers`` when ``workers > 1``): the serial, overlapped and unfused
    step times of the spec's (arch × method × workers).  An adaptive
    cell is resolved first, as the JAX package's ``_train`` does it.

    ``worker_args`` are appended to every subprocess argv (the bench's
    and the pod worker's own flags, e.g. ``--full-size``); they are not
    spec fields, so spec hashes stay the JAX package's.  ``device`` is
    resolved at construction (``launch.mesh.resolve_device``): without a
    GPU anything but ``"cpu"`` raises.
    """
    name = "measured"

    def __init__(self, reps: int = 5, warmup: int = 2,
                 device: str = "cuda",
                 subprocess_timeout: float = 1800,
                 worker_args: tuple = ()):
        from repro_torch.launch import mesh as mesh_mod
        self.reps = reps
        self.warmup = warmup
        self.device = mesh_mod.resolve_device(device)
        self.subprocess_timeout = subprocess_timeout
        self.worker_args = tuple(str(a) for a in worker_args)

    def run(self, spec: ExperimentSpec) -> Result:
        try:
            if spec.kind == "dryrun":
                return Result(spec, self.name, status="error", error=(
                    "kind='dryrun' reads the JAX package's launch/dryrun "
                    "(HLO roofline), which has no counterpart in "
                    "repro_torch yet"))
            if spec.kind == "train":
                return self._train(spec)
            return self._live(spec)
        except Exception as e:
            return Result(spec, self.name, status="error",
                          error=f"{type(e).__name__}: {e}")

    # ---- measured train-step schedules (serial vs overlapped) -----------
    def _bench_args(self, spec: ExperimentSpec,
                    method: Optional[str] = None) -> tuple[str, list]:
        """(compressor name, plan flags) of a train or pod cell: live
        kwargs and ``overrides`` as ``--plan``, and the spec's ``zero1``,
        ``accum`` and ``comm``.  ``method`` replaces the spec's (an
        adaptive cell's resolved scheme).  Raises ``ValueError`` for a
        live kwarg with no ParallelPlan field, and for an adaptive cell
        left unresolved: only ``_train`` resolves one."""
        if method is None and spec.is_adaptive:
            raise ValueError(
                "an adaptive pod cell is not resolved: only the measured "
                "train cell asks the adaptive controller for a plan, and "
                "the JAX package's MultiProcessBackend passes "
                "method='adaptive' to its pod worker, which has no such "
                "compressor")
        method, args = method or spec.method, []
        if spec.is_baseline:
            method = "none"
        elif method.startswith("live:"):
            method, args = live_plan_args(method)
        if spec.zero1:
            args += ["--zero1"]
        if spec.accum > 1:
            args += ["--accum", str(spec.accum)]
        if spec.comm != "auto":
            args += ["--comm", spec.comm]
        for k, v in spec.overrides:
            args += ["--plan", f"{k}={v}"]
        return method, args

    def _train(self, spec: ExperimentSpec) -> Result:
        workers = spec.workers or 4
        adaptive_choice = None
        method = None
        if spec.is_adaptive:
            # the controller's pick for this arch/workers cell, then the
            # measured run of that plan (JAX backend._train)
            from repro_torch.adaptive import controller as actl
            from repro_torch.configs import base as cfg_base
            arch_cfg = cfg_base.get(spec.workload)
            _, decision = actl.resolve_plan(arch_cfg.plan, arch_cfg, workers,
                                            batch=spec.batch)
            adaptive_choice = decision.scheme
            method = "none" if decision.is_baseline else decision.scheme
        try:
            method, plan_args = self._bench_args(spec, method)
        except ValueError as e:
            return Result(spec, self.name, status="error", error=str(e))
        launch = [sys.executable, "-m"]
        if workers > 1:
            launch += ["torch.distributed.run", "--standalone",
                       "--nproc-per-node", str(workers), "-m"]
        cmd = launch + ["repro_torch.train.overlap_bench",
                        "--arch", spec.workload,
                        "--device", self.device.type, "--method", method,
                        "--batch", str(spec.batch), "--json"] \
            + plan_args + list(self.worker_args)
        rec, err = run_subprocess_json(cmd, env=repro_pythonpath_env(),
                                       timeout=self.subprocess_timeout)
        if err is not None:
            return Result(spec, self.name, status="error",
                          error=f"overlap_bench {err}")
        if adaptive_choice is not None:
            rec["adaptive_choice"] = adaptive_choice
        return Result(spec, self.name, metrics=rec)

    # ---- live per-phase timing ------------------------------------------
    def _time(self, fn, *args) -> float:
        import torch
        cuda = self.device.type == "cuda"
        for _ in range(self.warmup):
            fn(*args)
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(self.reps):
            fn(*args)
        if cuda:
            torch.cuda.synchronize(self.device)
        return (time.perf_counter() - t0) / self.reps

    def _live(self, spec: ExperimentSpec) -> Result:
        import torch
        import torch.distributed as dist

        from repro_torch.launch import mesh as mesh_mod

        comp = make_live_compressor(spec.method)
        n = spec.n_elements or 1 << 20
        dev = self.device
        joined = not dist.is_initialized()    # leave a caller's group alone
        mesh_mod.init_world(dev)
        try:
            if dist.get_world_size() != 1:
                raise ValueError(f"a live cell times one rank; this "
                                 f"process's group has "
                                 f"{dist.get_world_size()}")
            axes = ("data",)
            g = torch.randn((n,), device=dev, generator=torch.Generator(
                device=dev).manual_seed(0))
            st = comp.init_state(n, torch.Generator(device=dev).manual_seed(1),
                                 device=dev)
            payload = comp.encode_and_reduce(g, st, axes)
            t_enc = self._time(comp.encode_and_reduce, g, st, axes)
            t_dec = self._time(comp.decode, payload, g, st)
            t_all = self._time(comp.aggregate, g, st, axes)
        finally:
            if joined:
                dist.destroy_process_group()
        m = dict(method=comp.name, n=n,
                 t_encode_us=round(t_enc * 1e6, 1),
                 t_decode_us=round(t_dec * 1e6, 1),
                 us_per_call=round(t_all * 1e6, 1),
                 wire_bytes=int(comp.compressed_bytes(n)),
                 rounds=len(comp.wire_round_bytes(n)),
                 associative=comp.associative,
                 ratio=round(comp.compression_ratio(n), 1))
        return Result(spec, self.name, metrics=m)
