"""Adaptive compression.  Counterpart of ``repro.adaptive``; the port has
its error-feedback half (``feedback``).  The perf-model-driven controller
(``policy``, ``controller``) is not ported yet."""
from repro_torch.adaptive.feedback import (EF_PREFIX, EFState,  # noqa: F401
                                           ErrorFeedback, wrap_error_feedback)
