"""Devices, process groups and the mesh axis names of the port.

The JAX package names its mesh axes (``pod``, ``data``, ``model``) and
reduces over them inside ``shard_map``.  The port keeps the names as the
public vocabulary and maps each to a ``torch.distributed`` process group.
This slice has one axis, ``data``, spanning the whole world: NCCL on the
card, gloo on the CPU.  Naming any other axis raises until its slice.
"""
from __future__ import annotations

import math
import os
import socket
from typing import Sequence

import torch
import torch.distributed as dist

#: the mesh axes this slice knows.
AXES = ("data",)


def resolve_device(device: "str | torch.device | None" = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  Without a GPU, anything but ``cpu`` raises; nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(device: torch.device) -> None:
    """Join the process group, unless this process already has one:
    ``torchrun``'s environment when it is set, else a group of one rank on
    a free localhost port.  A CUDA run gets NCCL for CUDA tensors and gloo
    for CPU tensors; a CPU run gets gloo."""
    if dist.is_initialized():
        return
    backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1)


def group(axes: Sequence[str]):
    """The process group that reduces over ``axes``."""
    unknown = [a for a in axes if a not in AXES]
    if unknown:
        raise NotImplementedError(
            f"mesh axes {unknown} are not ported yet (have {AXES})")
    return dist.group.WORLD


def rank(axes: Sequence[str]) -> int:
    """This process's index along ``axes`` (``jax.lax.axis_index``)."""
    return dist.get_rank(group(axes))


def axis_sizes() -> dict[str, int]:
    return {"data": dist.get_world_size()}


def size(axes: Sequence[str]) -> int:
    sizes = axis_sizes()
    group(axes)
    return math.prod(sizes[a] for a in axes)
