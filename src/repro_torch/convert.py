"""Carry the JAX package's state over into the port.

PyTorch's and JAX's random generators never give the same draws, so
comparisons of the two start from carried-over state: the parameter tree
and the per-bucket compressor state (PowerSGD ``q``/``err``, SignSGD
``err``).  Everything arrives as numpy arrays (``jax.device_get`` on the
JAX side); this module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {dotted key path: array}, in sorted-key (JAX leaf)
    order."""
    out: dict[str, np.ndarray] = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def load_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Copy a JAX parameter tree into ``model`` (same names and shapes)."""
    flat = flatten(tree)
    params = dict(model.named_parameters())
    if list(flat) != list(params):
        raise ValueError(f"parameter names differ: {list(flat)} vs "
                         f"{list(params)}")
    with torch.no_grad():
        for name, p in params.items():
            src = torch.from_numpy(np.array(flat[name], dtype=np.float32))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(src)


def agg_states(compressor, states: Sequence[Any], index: Optional[int] = 0,
               device: "str | torch.device" = "cpu") -> tuple:
    """Per-bucket JAX compressor states (NamedTuples of arrays) -> the
    port's.  ``index`` picks one rank's row of the leading device dim the
    JAX TrainState carries; ``None`` when there is none."""
    cls = type(compressor.init_state(1, None, device="meta"))
    out = []
    for st in states:
        fields = {}
        for name in cls._fields:
            a = np.asarray(getattr(st, name))
            if index is not None:
                a = a[index]
            fields[name] = torch.from_numpy(np.array(a)).to(device)
        out.append(cls(**fields))
    return tuple(out)
