"""The sweep subsystem: ``ExperimentSpec`` → ``Backend`` → ``Runner``.
Counterpart of ``repro.experiments``.

The paper's 200-setup evaluation matrix as one declarative API — specs are
frozen/hashable/JSON-round-trippable data (the JAX package's hashes),
backends evaluate them (analytically, or by measuring the port on its
device), and the runner persists and resumes sweeps by spec hash.
"""
from repro_torch.experiments.backend import (AnalyticBackend,  # noqa: F401
                                             Backend, MeasuredBackend,
                                             Result, live_method_id,
                                             make_live_compressor,
                                             run_subprocess_json)
from repro_torch.experiments.multiproc import \
    MultiProcessBackend  # noqa: F401
from repro_torch.experiments.report import (headline,  # noqa: F401
                                            headline_rows,
                                            headline_verdicts)
from repro_torch.experiments.runner import ResultStore, Runner  # noqa: F401
from repro_torch.experiments.spec import (PAPER_METHODS,  # noqa: F401
                                          PAPER_WORKER_COUNTS,
                                          PAPER_WORKLOADS, ExperimentSpec,
                                          Grid, hardware_fields,
                                          method_fields, workload_fields)
