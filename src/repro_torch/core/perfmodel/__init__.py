"""The paper's performance model.  Counterpart of
``repro.core.perfmodel``, without its HLO roofline (``roofline``,
``hloparse``), which is not ported."""
from repro_torch.core.perfmodel import (calibration, costs,  # noqa: F401
                                        hardware, model, whatif)
