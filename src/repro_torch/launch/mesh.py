"""Devices, process groups and the mesh axis names of the port.

The JAX package names its mesh axes (``pod``, ``data``, ``model``) and
reduces over them inside ``shard_map``.  The port keeps the names as the
public vocabulary and maps each to a ``torch.distributed`` process group.

Two meshes:

* the default: one ``data`` axis over the whole world (``pod`` has size 1);
* the two-tier ``pod x data`` mesh of :func:`init_pod_mesh` (JAX
  ``launch/mesh.py`` ``make_pod_mesh``): world rank ``r`` sits at
  ``pod = r // local`` and ``data = r % local``, pod-major as JAX reshapes
  ``jax.devices()``.  Each pod row is a ``data`` group and each column a
  ``pod`` group; ``("pod", "data")`` is the world group.

Collective backends are chosen from the topology, never by catching an
error: a ``pod`` group is gloo (the JAX pod tier is gloo over loopback by
construction); a ``data`` group, and the world group's CUDA side, is NCCL
only when every rank on this host has a card of its own, since NCCL
refuses two ranks on one device; otherwise gloo.  A CPU run is gloo.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

#: the mesh axes, outermost first (``("pod", "data")`` ranks pod-major).
AXES = ("pod", "data")


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


def local_device(device: str = "cuda") -> torch.device:
    """The device of this process: ``cuda:(LOCAL_RANK % device_count)``
    under a launcher that sets ``LOCAL_RANK`` (so several ranks may share
    one card), the resolved ``device`` otherwise; the current CUDA device
    is set to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None \
            and "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def nccl_allowed(device: torch.device) -> bool:
    """NCCL for this device's collectives: on the card, and only when no
    two ranks of this host share one, read from the topology: the host's
    rank count (``LOCAL_WORLD_SIZE``, else the world size) against
    ``torch.cuda.device_count()``."""
    if device.type != "cuda":
        return False
    here = int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))
    return here <= torch.cuda.device_count()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def set_rank_env(rank: int, world: int, coordinator: str) -> None:
    """The environment ``torchrun`` gives a rank, for a process started by
    hand on this host (every rank on one host): ``rank`` of ``world``, and
    ``coordinator`` (``host:port``) bound by rank 0.  Leaves an existing
    ``RANK`` alone."""
    if "RANK" in os.environ:
        return
    host, _, port = coordinator.rpartition(":")
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR=host, MASTER_PORT=port)


def init_world(device: torch.device) -> None:
    """Join the process group, unless this process already has one:
    ``torchrun``'s environment when it is set, else a group of one rank on
    a free localhost port.  On the card the group takes NCCL for CUDA
    tensors and gloo for CPU tensors, unless ranks share a card; then, as
    on the CPU, gloo for both."""
    if dist.is_initialized():
        return
    backend = "cpu:gloo,cuda:nccl" if nccl_allowed(device) else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1)


@dataclasses.dataclass(frozen=True)
class PodMesh:
    """This rank's view of a ``pod x data`` mesh: the axis sizes, its row
    (``data``) and column (``pod``) groups and their backends."""
    procs: int
    local: int
    groups: dict                     # axis -> this rank's process group
    backends: dict                   # axis -> "gloo" | "nccl"
    world: object                    # the world group it was built on


_POD: Optional[PodMesh] = None


def init_pod_mesh(procs: int, local: int, device: torch.device) -> PodMesh:
    """Split the world (``procs * local`` ranks, joined already) into the
    two-tier mesh.  Every rank creates every group, rows then columns, in
    the same order.  Returns the mesh and makes it this process's mesh
    until the world group goes."""
    global _POD
    world = dist.get_world_size()
    if procs * local != world:
        raise ValueError(f"a pod mesh of {procs} x {local} needs "
                         f"{procs * local} ranks, the world has {world}")
    rank = dist.get_rank()
    data_backend = "nccl" if nccl_allowed(device) else "gloo"
    groups = {}
    for p in range(procs):
        g = dist.new_group([p * local + i for i in range(local)],
                           backend=data_backend)
        if rank // local == p:
            groups["data"] = g
    for d in range(local):
        g = dist.new_group([p * local + d for p in range(procs)],
                           backend="gloo")
        if rank % local == d:
            groups["pod"] = g
    _POD = PodMesh(procs, local, groups,
                   {"pod": "gloo", "data": data_backend},
                   dist.group.WORLD)
    return _POD


def pod_mesh() -> Optional[PodMesh]:
    """The pod mesh of the current world group, or None (the default
    mesh)."""
    if _POD is not None and dist.is_initialized() \
            and _POD.world is dist.group.WORLD:
        return _POD
    return None


def present_axes() -> tuple[str, ...]:
    """The mesh's axes: ``("pod", "data")`` on a pod mesh, else
    ``("data",)``."""
    return AXES if pod_mesh() is not None else ("data",)


def axis_sizes() -> dict[str, int]:
    pm = pod_mesh()
    if pm is not None:
        return {"pod": pm.procs, "data": pm.local}
    return {"pod": 1, "data": dist.get_world_size()}


def backends() -> dict[str, str]:
    """Each present axis's collective backend, and the world group's."""
    pm = pod_mesh()
    out = dict(pm.backends) if pm is not None else {}
    world = dist.get_backend()
    out.setdefault("data", world)
    out["world"] = world
    return out


def _check(axes: Sequence[str]) -> tuple[str, ...]:
    axes = tuple(axes)
    unknown = [a for a in axes if a not in AXES]
    if unknown:
        raise NotImplementedError(
            f"mesh axes {unknown} are not ported yet (have {AXES})")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} name an axis twice")
    return axes


def group(axes: Sequence[str]):
    """The process group that reduces over ``axes`` (in any order)."""
    axes = _check(axes)
    pm = pod_mesh()
    if pm is None:
        if "pod" in axes:
            raise ValueError("no pod axis: call init_pod_mesh first")
        return dist.group.WORLD
    if len(axes) == 1:
        return pm.groups[axes[0]]
    return dist.group.WORLD


def coords() -> dict[str, int]:
    """This rank's index along each axis."""
    r = dist.get_rank()
    pm = pod_mesh()
    if pm is None:
        return {"pod": 0, "data": r}
    return {"pod": r // pm.local, "data": r % pm.local}


def rank(axes: Sequence[str]) -> int:
    """This process's index along ``axes``, row-major in the order given
    (``jax.lax.axis_index``)."""
    axes = _check(axes)
    group(axes)
    sizes, at = axis_sizes(), coords()
    out = 0
    for a in axes:
        out = out * sizes[a] + at[a]
    return out


def size(axes: Sequence[str]) -> int:
    axes = _check(axes)
    sizes = axis_sizes()
    group(axes)
    return math.prod(sizes[a] for a in axes)
