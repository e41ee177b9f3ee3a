"""MultiProcessBackend: measured cells on a real multi-process pod.
Counterpart of ``repro.experiments.multiproc``.

Every other measured cell runs one process.  This backend starts one
``repro_torch.train.pod_worker`` process per rank of a ``spec.procs x
(spec.workers // spec.procs)`` pod: the ranks join one
``torch.distributed`` world on a localhost coordinator
(``launch.mesh.set_rank_env``) and split it into the two-tier
``pod x data`` mesh, whose ``pod`` tier is gloo (the measured slow tier).

Inherits ``MeasuredBackend``: specs without ``procs >= 2`` fall through
to the in-process paths, so one backend sweeps mixed grids.  Failure
paths are first-class ``Result`` rows (nonzero exit / garbage JSON /
timeout -> ``status="error"`` with the failing rank's stderr tail), never
an exception mid-sweep; on a timeout every rank's process group is
killed.

Rank 0's record feeds ``perfmodel.calibration.calibrate_from_results``
(the α–β fit over pod observations) and the ``report.headline()``
model-vs-measured error column.
"""
from __future__ import annotations

import sys

from repro_torch.experiments.backend import (MeasuredBackend, Result, _tail,
                                             parse_last_json_line,
                                             repro_pythonpath_env,
                                             run_processes)
from repro_torch.experiments.spec import ExperimentSpec


class MultiProcessBackend(MeasuredBackend):
    """``MeasuredBackend`` that runs ``kind="train"``, ``procs >= 2``
    specs on a pod of ``pod_worker`` rank processes."""
    name = "multiproc"

    def __init__(self, reps: int = 5, warmup: int = 2,
                 pod_timeout: float = 900, **kw):
        super().__init__(reps=reps, warmup=warmup, **kw)
        self.pod_timeout = pod_timeout

    def run(self, spec: ExperimentSpec) -> Result:
        if spec.kind == "train" and spec.procs >= 2:
            try:
                return self._pod(spec)
            except Exception as e:  # never raise mid-sweep
                return Result(spec, self.name, status="error",
                              error=f"{type(e).__name__}: {e}")
        return super().run(spec)

    # ------------------------------------------------------------------
    def _pod_cmds(self, spec: ExperimentSpec, port: int) -> list[list]:
        """One pod_worker argv per rank, ``--proc-id 0 .. workers-1``
        (test seam: failure-path tests substitute canned commands)."""
        procs = spec.procs
        workers = spec.workers or procs
        local, rem = divmod(workers, procs)
        if local < 1 or rem:
            raise ValueError(
                f"workers={workers} does not split over procs={procs} "
                f"(need workers = procs × local_devices)")
        method, plan_args = self._bench_args(spec)
        common = ["--procs", str(procs),
                  "--coordinator", f"127.0.0.1:{port}",
                  "--local-devices", str(local),
                  "--device", self.device.type,
                  "--arch", spec.workload, "--method", method,
                  "--batch", str(spec.batch),
                  "--reps", str(self.reps),
                  "--warmup", str(self.warmup), "--json"] + plan_args
        return [[sys.executable, "-m", "repro_torch.train.pod_worker",
                 "--proc-id", str(r)] + common + list(self.worker_args)
                for r in range(workers)]

    def _pod(self, spec: ExperimentSpec) -> Result:
        from repro_torch.launch import mesh as mesh_mod
        cmds = self._pod_cmds(spec, mesh_mod.free_port())
        env = repro_pythonpath_env()
        # one thread per rank for host-side work, as torchrun sets it
        env.setdefault("OMP_NUM_THREADS", "1")
        outs, timed_out = run_processes(cmds, env, self.pod_timeout)
        if timed_out is not None:
            return Result(spec, self.name, status="error",
                          error=f"pod_worker {timed_out} timeout after "
                                f"{self.pod_timeout:g}s: stderr: "
                                f"{_tail(outs[timed_out][2])}")
        for i, (rc, _, err) in enumerate(outs):
            if rc != 0:
                return Result(spec, self.name, status="error",
                              error=f"pod_worker {i} rc={rc}: "
                                    f"{_tail(err)}")
        out0, err0 = outs[0][1], outs[0][2]
        try:
            rec = parse_last_json_line(out0)
        except ValueError as e:
            return Result(spec, self.name, status="error",
                          error=f"pod_worker 0 bad stdout JSON: {e}; "
                                f"stderr: {_tail(err0)}")
        return Result(spec, self.name, metrics=rec)
