"""Devices, process groups and the mesh axis names of the port.

The JAX package names its mesh axes (``pod``, ``data``, ``model``) and
reduces over them inside ``shard_map``.  The port keeps the names as the
public vocabulary and maps each to a ``torch.distributed`` process group.

Two meshes, each with an optional ``model`` axis of size ``tp``
(tensor, sequence and expert parallelism), innermost, as JAX reshapes
the devices ``(procs, local, tp)`` (``launch/mesh.py`` ``make_pod_mesh``):

* the default: one ``data`` axis over the world (``pod`` has size 1),
  or ``data x model`` after :func:`init_mesh` (``data = world // tp``);
* the two-tier ``pod x data [x model]`` mesh of :func:`init_pod_mesh`:
  world rank ``r`` sits at ``model = r % tp``, ``data = (r // tp) %
  local`` and ``pod = r // (tp * local)``.

Each set of axes a reduction uses has its process group: the ranks that
differ only along those axes.  ``("pod", "data")`` is the DP group of
one model index (the world when ``tp`` is 1), ``("model",)`` the TP
group of one DP coordinate.  Every rank creates every group, in the
same order.

Collective backends are chosen from the topology, never by catching an error: a
group spanning pods is gloo (the JAX pod tier is gloo over loopback by
construction), and so is the ``pod`` group; any other group (``data``,
``model`` and their combinations), and the world group's CUDA side, is NCCL
only when every rank on this host has a card of its own, since NCCL refuses two
ranks on one device; otherwise gloo. A CPU run is gloo.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

#: the mesh axes, outermost first (ranks pod-major, ``model`` innermost).
AXES = ("pod", "data", "model")
#: the tensor-parallel axis (JAX ``parallel/collectives.py`` ``TP_AXIS``)
TP_AXIS = "model"


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
    """This rank's view of a ``pod x data x model`` mesh: the axis sizes,
    its single-axis groups (``groups``) and those of the sets of axes
    the reductions use (``combos``, keyed by the frozen set of the axes,
    ``_axis_sets``), their backends,
    and whether ``pod`` is one of the mesh's axes."""
    procs: int
    local: int
    groups: dict                     # axis -> this rank's process group
    backends: dict                   # axis -> "gloo" | "nccl"
    world: object                    # the world group it was built on
    tp: int = 1
    combos: dict = dataclasses.field(default_factory=dict)
    has_pod: bool = True


_POD: Optional[PodMesh] = None


def _coords_of(r: int, local: int, tp: int) -> dict[str, int]:
    return {"pod": r // (tp * local), "data": (r // tp) % local,
            "model": r % tp}


def _axis_sets(tp: int) -> list[tuple[str, ...]]:
    """Every proper set of axes whose group the mesh creates, in creation
    order: ``pod`` and ``data`` alone (rows then columns, as before a
    ``model`` axis existed), then, with ``tp > 1``, the sets the
    reductions use: ``model`` (the TP collectives), ``("data", "model")``
    (the norms of a leaf sharded over ``model`` on the default mesh) and
    ``("pod", "data")`` (the DP group of one model index)."""
    out = [("data",), ("pod",)]
    if tp > 1:
        out += [("model",), ("data", "model"), ("pod", "data")]
    return out


def init_pod_mesh(procs: int, local: int, device: torch.device,
                  tp: int = 1, has_pod: bool = True) -> PodMesh:
    """Split the world (``procs * local * tp`` ranks, joined already) into
    the mesh.  Every rank creates every group in the same order.  Returns
    the mesh and makes it this process's mesh until the world group
    goes."""
    global _POD
    world = dist.get_world_size()
    if procs * local * tp != world:
        raise ValueError(f"a pod mesh of {procs} x {local} x {tp} needs "
                         f"{procs * local * tp} ranks, the world has "
                         f"{world}")
    rank = dist.get_rank()
    near = "nccl" if nccl_allowed(device) else "gloo"
    at = [_coords_of(r, local, tp) for r in range(world)]
    combos, backends = {}, {}
    for axes in _axis_sets(tp):
        # gloo across pods; the pod axis alone is gloo whatever its size,
        # as it has always been
        backend = "gloo" if axes == ("pod",) or ("pod" in axes
                                                 and procs > 1) else near
        rest = [a for a in AXES if a not in axes]
        members: dict = {}
        for r in range(world):
            members.setdefault(tuple(at[r][a] for a in rest), []).append(r)
        for key in sorted(members):
            g = dist.new_group(members[key], backend=backend)
            if key == tuple(at[rank][a] for a in rest):
                combos[frozenset(axes)] = g
        backends[axes] = backend
    combos[frozenset(AXES)] = dist.group.WORLD
    if tp == 1:
        combos[frozenset(("pod", "data"))] = dist.group.WORLD
    groups = {a: combos[frozenset((a,))] for a in ("pod", "data", "model")
              if frozenset((a,)) in combos}
    single = {a[0]: b for a, b in backends.items() if len(a) == 1}
    _POD = PodMesh(procs, local, groups, single, dist.group.WORLD, tp,
                   combos, has_pod)
    return _POD


def init_mesh(tp: int, device: torch.device) -> PodMesh:
    """The default mesh with a ``model`` axis: ``data = world // tp``,
    ``model = tp`` (one pod); the DP axis is ``data`` alone."""
    world = dist.get_world_size()
    if world % tp:
        raise ValueError(f"tp={tp} does not divide the world ({world})")
    return init_pod_mesh(1, world // tp, device, tp, has_pod=False)


def pod_mesh() -> Optional[PodMesh]:
    """The mesh of the current world group, or None (the default
    mesh)."""
    if _POD is not None and dist.is_initialized() \
            and _POD.world is dist.group.WORLD:
        return _POD
    return None


def present_axes() -> tuple[str, ...]:
    """The mesh's DP axes: ``("pod", "data")`` on a pod mesh, else
    ``("data",)``."""
    pm = pod_mesh()
    return ("pod", "data") if pm is not None and pm.has_pod else ("data",)


def tp_size() -> int:
    """The size of the ``model`` axis (1 without one)."""
    pm = pod_mesh()
    return pm.tp if pm is not None else 1


def axis_sizes() -> dict[str, int]:
    """Each axis's size; ``model`` only when the mesh has one of more
    than one rank."""
    pm = pod_mesh()
    if pm is None:
        return {"pod": 1, "data": dist.get_world_size()}
    out = {"pod": pm.procs, "data": pm.local}
    if pm.tp > 1:
        out["model"] = pm.tp
    return out


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
    """The process group that reduces over ``axes`` (in any order): the
    ranks that differ from this one only along them."""
    axes = _check(axes)
    pm = pod_mesh()
    if pm is None:
        if "pod" in axes:
            raise ValueError("no pod axis: call init_pod_mesh first")
        if TP_AXIS in axes:
            raise ValueError("no model axis: call init_mesh or "
                             "init_pod_mesh with tp > 1 first")
        return dist.group.WORLD
    key = frozenset(axes)
    if pm.tp == 1:
        if TP_AXIS in key and len(key) == 1:
            raise ValueError("the model axis has size 1: no group")
        key = key - {TP_AXIS}
    if not key:         # no axis: the world, as the default mesh has it
        return dist.group.WORLD
    if key not in pm.combos:
        raise ValueError(f"no process group for the axes {tuple(axes)}: "
                         f"the mesh builds those of {_axis_sets(pm.tp)}")
    return pm.combos[key]


def coords() -> dict[str, int]:
    """This rank's index along each axis (``model`` only on a mesh that
    has one)."""
    r = dist.get_rank()
    pm = pod_mesh()
    if pm is None:
        return {"pod": 0, "data": r}
    out = _coords_of(r, pm.local, pm.tp)
    if pm.tp == 1:
        del out["model"]
    return out


def rank(axes: Sequence[str]) -> int:
    """This process's index along ``axes``, row-major in the order given
    (``jax.lax.axis_index``)."""
    axes = _check(axes)
    group(axes)
    sizes, at = axis_sizes(), coords()
    out = 0
    for a in axes:
        out = out * sizes.get(a, 1) + at.get(a, 0)
    return out


def size(axes: Sequence[str]) -> int:
    axes = _check(axes)
    sizes = axis_sizes()
    group(axes)
    return math.prod(sizes.get(a, 1) for a in axes)


def group_rank0(axes: Sequence[str]) -> int:
    """The world rank of the member of ``group(axes)`` at index 0 along
    every one of ``axes`` (the source of a broadcast over them)."""
    pm = pod_mesh()
    at = coords()
    tp = pm.tp if pm is not None else 1
    local = pm.local if pm is not None else dist.get_world_size()
    for a in axes:
        at[a] = 0
    return (at.get("pod", 0) * local + at.get("data", 0)) * tp \
        + at.get("model", 0)
