"""The experiment layer's backends.  Counterpart of
``repro.experiments.backend``; for now only :func:`coerce_kv`, which the
pod worker's ``--plan FIELD=VALUE`` overrides read.  The analytic and
measured backends come with the experiment-layer slice.
"""
from __future__ import annotations

from typing import Any


def coerce_kv(v: str) -> Any:
    """``"8"`` -> 8, ``"0.01"`` -> 0.01, ``"true"`` -> True, else str."""
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return {"true": True, "false": False}.get(v.lower(), v)
