"""Adaptive compression.  Counterpart of ``repro.adaptive``; the port has
its error-feedback half (``feedback``) and the decision rule (``policy``).
The runtime controller (``controller``) is not ported yet."""
from repro_torch.adaptive.feedback import (EF_PREFIX, EFState,  # noqa: F401
                                           ErrorFeedback, wrap_error_feedback)
from repro_torch.adaptive.policy import (Candidate, Decision,  # noqa: F401
                                         bucket_workloads, decide,
                                         paper_candidates)
