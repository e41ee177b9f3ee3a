"""Adaptive compression: error feedback and a perf-model-driven
controller.  Counterpart of ``repro.adaptive``.

* ``feedback``: the ``ef:<name>`` error-feedback wrapper on the Payload
  contract (residual added before encode, decode error written back after
  the reduce, state checkpointed with the optimizer);
* ``policy`` and ``controller``: the per-bucket decision rule that
  compresses only when the performance model (corrected by measured
  feedback) predicts a win, and otherwise falls back to the overlapped
  syncSGD baseline.
"""
from repro_torch.adaptive.controller import (BucketController,  # noqa: F401
                                             ControllerConfig, resolve_plan,
                                             workload_for_arch)
from repro_torch.adaptive.feedback import (EF_PREFIX, EFState,  # noqa: F401
                                           ErrorFeedback, wrap_error_feedback)
from repro_torch.adaptive.policy import (Candidate, Decision,  # noqa: F401
                                         bucket_workloads, decide,
                                         paper_candidates)
