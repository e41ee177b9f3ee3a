"""Compressor API: ``encode -> Payload -> reduce -> decode``.

Counterpart of ``repro.core.compression.base``; the contract is the same:

    encode(bucket, state, rank) -> Payload
        Local and collective-free: the 1-D gradient bucket plus carried
        state (error feedback, warm starts) become the exact tensors that
        cross the wire.
    reduce(payload, axes, plan) -> Payload  [``reduce_payload``]
        The only phase that touches the network.  The collective is the
        declarative :class:`CommPlan`; the payload's ``associative`` flag
        validates the plan instead of dispatching it.
    decode(payload, bucket, state) -> (mean_bucket, new_state)
        Local and collective-free.  ``payload.local`` carries this rank's
        pre-reduce tensors.

``aggregate`` composes the three and is what the train step calls.  Wire
bytes are derived from the payloads: ``wire_round_bytes`` runs the encode
path on the ``meta`` device, so it allocates nothing and launches no
kernel.  ``compressed_bytes``, ``compression_ratio`` and
``encode_decode_flops`` are what the performance model reads.

Ported compressors: every name of the JAX registry (``none``,
``powersgd``, ``signsgd``, ``qsgd``, ``terngrad``, ``randomk``,
``mstopk``), and any of them but ``powersgd`` behind the ``ef:`` prefix
(``make("ef:randomk")``): the error-feedback wrapper of
``repro_torch.adaptive.feedback`` around the inner compressor, with the
inner scheme's plan fields.

Randomness.  A stochastic compressor's state carries a ``key``: two
32-bit words in an ``int64`` tensor that stays on the host (the layout of
``jax.random.key_data``).  Its draws come from a generator on the bucket's
device seeded from the key (``key_generator``), so drawing costs no
host-device synchronisation; ``decode`` advances the key as JAX's
``split`` does (``split_key``).  Torch's Philox and JAX's threefry give
different draws from the same key, so the parity tests replace each
scheme's one draw function with JAX's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import commplan as cp

AxisNames = Sequence[str]

#: name prefix resolving to the error-feedback wrapper.
EF_PREFIX = "ef:"


# --------------------------------------------------------------------------
# keys of the stochastic compressors
# --------------------------------------------------------------------------
def new_key(generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A fresh key on the host: two words drawn from ``generator`` (zeros
    without one)."""
    if generator is None:
        return torch.zeros((2,), dtype=torch.int64)
    return torch.randint(0, 2**32, (2,), generator=generator,
                         device=generator.device, dtype=torch.int64).cpu()


def _seed(key: torch.Tensor, salt: int = 0) -> int:
    k0, k1 = key.tolist()
    return ((k0 << 32 | k1) ^ (salt * 0x9E3779B97F4A7C15)) % 2**64


def split_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(carry, sub): the key to keep and one to draw from, as JAX's
    ``split`` gives them; computed on the host."""
    gen = torch.Generator().manual_seed(_seed(key))
    words = torch.randint(0, 2**32, (4,), generator=gen, dtype=torch.int64)
    return words[:2], words[2:]


def key_generator(key: torch.Tensor, device: "str | torch.device",
                  salt: int = 0) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded from ``key`` and ``salt`` (a rank,
    as JAX's ``fold_in``); ``None`` on ``meta``, where nothing is drawn."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(_seed(key, salt))


def rank_uniform(key: torch.Tensor, rank: Optional[int], n: int,
                 device: "str | torch.device") -> torch.Tensor:
    """The (n,) uniform draw in [0, 1) of one encode: from the key's ``sub``
    half, different on each rank (JAX: ``uniform(fold_in(sub, rank))``)."""
    _, sub = split_key(key)
    return torch.rand((n,), generator=key_generator(sub, device, rank or 0),
                      device=device)


# --------------------------------------------------------------------------
# Payload: the self-describing wire format
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Payload:
    """One collective round's wire content.

    ``tensors``      name -> tensor; these exact tensors cross the wire
                     (before ``reduce``) or came back from it (after).
    ``associative``  True -> the reduction is a mean of these tensors;
                     False -> every rank needs every rank's tensors
                     (all-gather), which come back with a leading peer
                     axis of size p.
    ``local``        after ``reduce_payload``: this rank's pre-reduce
                     ``tensors``.
    """
    tensors: dict
    associative: bool = True
    local: Any = None

    @property
    def nbytes(self) -> int:
        """Per-peer wire bytes of this round (meaningful pre-reduce)."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.tensors.values()))

    def wire_spec(self) -> dict:
        """{tensor name: {shape, dtype, nbytes}} — the declared wire
        format (dtype names as numpy spells them)."""
        return {k: dict(shape=tuple(t.shape),
                        dtype=str(t.dtype).removeprefix("torch."),
                        nbytes=int(t.numel() * t.element_size()))
                for k, t in self.tensors.items()}


def reduce_payload(payload: Payload, axes: AxisNames,
                   plan: Optional[cp.CommPlan] = None) -> Payload:
    """The reduce phase: THE single place a compression payload meets a
    collective.  ``plan=None`` (``auto``) all-reduces associative payloads
    and all-gathers the rest; illegal combinations raise
    :class:`repro_torch.parallel.commplan.CommPlanError`."""
    axes = tuple(axes)
    plan = cp.CommPlan.parse(plan).resolve(payload.associative)
    if payload.associative:
        tensors = {k: cp.mean_reduce(t, axes, plan)
                   for k, t in payload.tensors.items()}
    else:
        tensors = {k: cp.gather_tensor(t, axes)
                   for k, t in payload.tensors.items()}
    return dataclasses.replace(payload, tensors=tensors,
                               local=payload.tensors)


# --------------------------------------------------------------------------
# the three-phase contract
# --------------------------------------------------------------------------
class Compressor:
    name: str = "abstract"
    associative: bool = True
    #: True -> error feedback is structural (always-on state, PowerSGD):
    #: the ``ef:`` wrapper rejects these instead of compensating twice.
    builtin_error_feedback: bool = False

    @property
    def all_reduce_compatible(self) -> bool:
        """Alias of ``associative`` (the paper's Table 3 wording)."""
        return self.associative

    def init_state(self, n: int, generator: Optional[torch.Generator] = None,
                   device: "str | torch.device" = "cpu") -> Any:
        """Per-bucket persistent state (error feedback, warm start)."""
        return ()

    def _compensated(self, bucket: torch.Tensor, state: Any) -> torch.Tensor:
        """Error-compensated fp32 gradient: g + the carried residual."""
        g = bucket.float()
        return g + state.err if getattr(self, "error_feedback", False) else g

    def encode(self, bucket: torch.Tensor, state: Any,
               rank: Optional[int] = None) -> Payload:
        raise NotImplementedError

    def encode_and_reduce(self, bucket: torch.Tensor, state: Any,
                          axes: AxisNames,
                          plan: Optional[cp.CommPlan] = None) -> Payload:
        rank = dist.get_rank(mesh_mod.group(axes)) if tuple(axes) else 0
        return reduce_payload(self.encode(bucket, state, rank=rank), axes,
                              plan)

    def decode(self, payload: Payload, bucket: torch.Tensor, state: Any):
        raise NotImplementedError

    def aggregate(self, bucket: torch.Tensor, state: Any, axes: AxisNames,
                  plan: Optional[cp.CommPlan] = None):
        payload = self.encode_and_reduce(bucket, state, axes, plan)
        return self.decode(payload, bucket, state)

    # ---- wire accounting: derived from the payloads ----------------------
    def wire_rounds(self, bucket: torch.Tensor, state: Any) -> list[Payload]:
        """One Payload per collective round, collective-free."""
        return [self.encode(bucket, state)]

    def wire_round_bytes(self, n: int, itemsize: int = 4) -> tuple[int, ...]:
        """Per-round wire bytes (per peer), from the encode path run on
        the ``meta`` device."""
        cache = self.__dict__.setdefault("_wire_cache", {})
        if (n, itemsize) not in cache:
            dtype = {2: torch.bfloat16, 4: torch.float32,
                     8: torch.float64}.get(itemsize, torch.float32)
            bucket = torch.zeros((n,), dtype=dtype, device="meta")
            state = self.init_state(n, None, device="meta")
            cache[(n, itemsize)] = tuple(
                p.nbytes for p in self.wire_rounds(bucket, state))
        return cache[(n, itemsize)]

    def compressed_bytes(self, n: int, itemsize: int = 4) -> float:
        """Wire payload per aggregation (one direction, per peer): the sum
        of every round's bytes."""
        return float(sum(self.wire_round_bytes(n, itemsize)))

    def compression_ratio(self, n: int, itemsize: int = 4) -> float:
        return (n * itemsize) / max(self.compressed_bytes(n, itemsize), 1e-9)

    # ---- analytical flops (the paper's T_encode-decode, up to a constant) -
    def encode_decode_flops(self, n: int) -> float:
        return 0.0


# --------------------------------------------------------------------------
# registry: the single plan -> compressor-kwargs mapping
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CompressorSpec:
    name: str
    cls: type
    plan_fields: tuple[tuple[str, str], ...] = ()


_REGISTRY: dict[str, CompressorSpec] = {}


def register_compressor(name: str, **plan_fields: str) -> Callable[[type],
                                                                   type]:
    """Class decorator; ``plan_fields`` maps constructor kwargs to
    ``ParallelPlan`` attributes (``plan_kwargs`` reads it)."""
    def deco(cls: type) -> type:
        _REGISTRY[name] = CompressorSpec(name, cls, tuple(plan_fields.items()))
        cls.registry_name = name
        return cls
    return deco


def _load_builtins() -> None:
    from repro_torch.core.compression import (mstopk, none,  # noqa: F401
                                              powersgd, qsgd, randomk,
                                              signsgd, terngrad)


def registry() -> dict[str, CompressorSpec]:
    _load_builtins()
    return dict(_REGISTRY)


def _spec(name: str) -> CompressorSpec:
    """The registered spec of ``name``, or of its inner scheme for an
    ``ef:`` name."""
    _load_builtins()
    name = name.removeprefix(EF_PREFIX)
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def make(name: str, **kw) -> Compressor:
    """Factory: ``make('powersgd', rank=4)``; ``make('ef:<name>', **kw)``
    builds the inner compressor and wraps it in error feedback."""
    if name.startswith(EF_PREFIX):
        from repro_torch.adaptive.feedback import wrap_error_feedback
        return wrap_error_feedback(make(name[len(EF_PREFIX):], **kw))
    return _spec(name).cls(**kw)


def plan_kwargs_for(name: str, plan) -> dict:
    """Constructor kwargs for compressor ``name`` read off the registered
    spec's ``ParallelPlan`` field mapping; an ``ef:`` prefix delegates to
    the inner scheme's mapping."""
    return {kwarg: getattr(plan, field)
            for kwarg, field in _spec(name).plan_fields}


def plan_kwargs(plan) -> dict:
    """Constructor kwargs for ``plan.compression``."""
    return plan_kwargs_for(plan.compression, plan)


def from_plan(plan) -> Compressor:
    return make(plan.compression, **plan_kwargs(plan))
