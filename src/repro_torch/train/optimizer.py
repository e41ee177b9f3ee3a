"""AdamW, SGD with momentum and Adafactor, with global-norm clipping.
Counterpart of the replicated-parameter parts of ``repro.train.optimizer``
(``OptConfig``, ``global_norm``, ``clip_by_global_norm``, ``AdamW``,
``SGDM``, ``Adafactor``, ``make``) and of its flat-space AdamW for the
ZeRO-1 shards (``flat_adamw_init``, ``flat_adamw_update``).  The state
trees are the JAX package's, with the parameter tree as a list in
parameter order: AdamW ``{"m", "v", "t"}``, SGDM ``{"m", "t"}`` and
Adafactor ``{"s", "t"}``, whose ``s`` holds per leaf the factored row and
column statistics ``{"r", "c"}`` over the trailing two dims (leaves with
two dims or more) or a full second moment ``{"v"}``.

Under DDP the parameters are replicated over the data axis (fp32, or
bf16 working copies), so the global norm needs no collective; under TP
each leaf ``model`` shards adds its squares over ``model``.  Under FSDP
(``Sharding``: the FSDP axes and, per leaf, the dim they shard or None)
two places need the sharding, as in the JAX package: the global norm sums
each sharded leaf's squares over the FSDP axes (leaves grouped by their
axes, each group's sum reduced once; a replicated leaf is never summed
over them), and Adafactor's factored means sum over a sharded dim's axes
and divide by the global size, as does its per-matrix RMS clip.  Both
updates run one
elementwise function, ``adamw_math``, in the JAX package's operation
order and in fp32, whatever the parameter's dtype; that is what makes the
owner-sharded update bit-identical to the replicated one from the same
bf16 parameters.  Updates are written in place to save a copy of each
tensor; ``AdamW.update`` returns the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import commplan as cp


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"             # "adamw" | "adafactor" | "sgdm"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0          # 0 = off
    adafactor_eps1: float = 1e-30
    adafactor_clip: float = 1.0
    momentum: float = 0.9


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How FSDP and TP shard the parameters: the FSDP axes, and per leaf
    (in parameter order) the dim they shard, or None for a leaf they
    replicate; per leaf the dim ``model`` shards, or None (``tp_dims``,
    empty without TP).  Dims count from the end."""
    axes: tuple[str, ...]
    dims: tuple["int | None", ...]
    tp_dims: tuple["int | None", ...] = ()

    def leaf_axes(self, i: int) -> tuple[str, ...]:
        out = self.axes if self.dims[i] is not None else ()
        if self.tp_dims and self.tp_dims[i] is not None:
            out = out + ("model",)
        return out

    def dim_axes(self, i: int, ndim: int) -> list[tuple[str, ...]]:
        """Per dim of leaf ``i`` (of ``ndim`` dims), the axes that shard
        it."""
        out: list = [()] * ndim
        if self.dims[i] is not None:
            out[self.dims[i] % ndim] = tuple(self.axes)
        if self.tp_dims and self.tp_dims[i] is not None:
            out[self.tp_dims[i] % ndim] += ("model",)
        return out

    def reordered(self, index: Sequence[int]) -> "Sharding":
        """The sharding of the leaves ``index`` (parameter positions)."""
        return Sharding(self.axes, tuple(self.dims[i] for i in index),
                        tuple(self.tp_dims[i] for i in index)
                        if self.tp_dims else ())


def _psum(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    return cp.psum(t, axes) if axes else t


def global_norm(grads: Sequence[torch.Tensor],
                sharding: Optional[Sharding] = None) -> torch.Tensor:
    """fp32 L2 norm over every leaf, summed in leaf order; under
    ``sharding`` the global gradient's: the leaves grouped by the axes
    that shard them (in order of first appearance), each group's sum of
    squares summed over its axes, as the JAX package groups them."""
    if sharding is None or not (sharding.axes or sharding.tp_dims):
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for g in grads:
            total = total + g.float().square().sum()
        return total.sqrt()
    groups: dict = {}
    for i, g in enumerate(grads):
        key = sharding.leaf_axes(i)
        groups[key] = groups.get(key, 0.0) + g.float().square().sum()
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for axes, acc in groups.items():
        total = total + _psum(acc, axes)
    return total.sqrt()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        sharding: Optional[Sharding] = None):
    norm = global_norm(grads, sharding)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], norm


def adamw_math(p32: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, bc1: float, bc2: float, lr: float,
               c: OptConfig) -> None:
    """One AdamW step on fp32 tensors, in place on ``p32``, ``m`` and
    ``v``; ``g`` is cast to fp32.  The JAX package's order of operations
    (``upd1``, ``flat_adamw_update``), in eleven in-place passes over the
    elements (``alpha=`` and ``addcmul_`` fuse a scale into an add).  The
    replicated and the owner-sharded update both run this function, so
    they give the same bits for the same values."""
    g = g.float()
    m.mul_(c.b1).add_(g, alpha=1 - c.b1)
    v.mul_(c.b2).addcmul_(g, g, value=1 - c.b2)
    step = (m / bc1).div_((v / bc2).sqrt_().add_(c.eps))
    step.add_(p32, alpha=c.weight_decay)
    p32.sub_(step, alpha=lr)


def _bias_corrections(c: OptConfig, t: int) -> tuple[float, float]:
    return 1.0 - c.b1 ** t, 1.0 - c.b2 ** t


class AdamW:
    def __init__(self, cfg: OptConfig, sharding: Optional[Sharding] = None):
        self.cfg = cfg
        self.sharding = sharding

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "t": 0}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor], lr: float):
        """Parameters of any float dtype: the step runs in fp32 from
        ``p.float()`` and is written back in the parameter's dtype (a bf16
        parameter rounds once, as JAX's ``astype(p.dtype)``)."""
        c = self.cfg
        gnorm = global_norm(grads, self.sharding)
        # the clip of ``clip_by_global_norm``, applied a leaf at a time:
        # the same bits, one clipped leaf in memory rather than a copy of
        # the whole gradient
        scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0) if c.grad_clip else None
        t = state["t"] + 1
        bc1, bc2 = _bias_corrections(c, t)
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            # a leaf in FLAT_CHUNK slices: elementwise, so the same bits,
            # with the temporaries of a slice, not of a whole table
            pf, gf, mf, vf = (x.reshape(-1) for x in (p, g, m, v))
            for a in range(0, pf.shape[0], FLAT_CHUNK):
                b = a + FLAT_CHUNK
                gc = gf[a:b]
                if scale is not None:
                    gc = gc * scale.to(gc.dtype)
                pc = pf[a:b]
                p32 = pc.float()
                adamw_math(p32, gc, mf[a:b], vf[a:b], bc1, bc2, lr, c)
                if p32 is not pc:
                    pc.copy_(p32)
        return params, {"m": state["m"], "v": state["v"], "t": t}, \
            {"grad_norm": gnorm}


#: elements per pass of the flat update: its fp32 temporaries take a few
#: chunks, not a few copies of a 1.1 B-element shard (the arithmetic is
#: elementwise, so the bits do not depend on the chunking)
FLAT_CHUNK = 2**26


def flat_adamw_init(n: int, device: "str | torch.device") -> dict:
    return {"m": torch.zeros((n,), dtype=torch.float32, device=device),
            "v": torch.zeros((n,), dtype=torch.float32, device=device)}


@torch.no_grad()
def flat_adamw_update(p: torch.Tensor, g: torch.Tensor, st: dict, t: int,
                      lr: float, cfg: OptConfig):
    """1-D shard update (states sharded over DP = ZeRO-1): the fp32
    master ``p`` and ``st``'s moments in place.  Returns ``(p, st)``."""
    bc1, bc2 = _bias_corrections(cfg, t)
    for a in range(0, p.shape[0], FLAT_CHUNK):
        b = a + FLAT_CHUNK
        adamw_math(p[a:b], g[a:b], st["m"][a:b], st["v"][a:b], bc1, bc2, lr,
                   cfg)
    return p, st


def _clipped(grads: Sequence[torch.Tensor], c: OptConfig,
             sharding: Optional[Sharding] = None):
    if c.grad_clip:
        return clip_by_global_norm(grads, c.grad_clip, sharding)
    return list(grads), global_norm(grads, sharding)


class SGDM:
    def __init__(self, cfg: OptConfig, sharding: Optional[Sharding] = None):
        self.cfg = cfg
        self.sharding = sharding

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "t": 0}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor], lr: float):
        c = self.cfg
        grads, gnorm = _clipped(grads, c, self.sharding)
        for p, g, m in zip(params, grads, state["m"]):
            m.mul_(c.momentum).add_(g.float())
            p32 = p.float()
            p.copy_(p32 - lr * (m + c.weight_decay * p32))
        return params, {"m": state["m"], "t": state["t"] + 1}, \
            {"grad_norm": gnorm}


class Adafactor:
    """Factored second moment over the trailing two dims (leaves with
    ndim >= 2); 1-D leaves keep a full second moment.  No momentum.  The
    update's RMS clip is per matrix: per layer of a stacked ``(L, ...)``
    leaf of three dims or more (the JAX package maps those over their
    layer dim), over the whole leaf otherwise."""

    def __init__(self, cfg: OptConfig, sharding: Optional[Sharding] = None):
        self.cfg = cfg
        self.sharding = sharding

    def _dim_axes(self, i: int, ndim: int) -> list[tuple[str, ...]]:
        """Per dim of leaf ``i``, the axes that shard it."""
        if self.sharding is None:
            return [()] * ndim
        return self.sharding.dim_axes(i, ndim)

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        def st(p):
            if p.ndim >= 2:
                return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                         device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=torch.float32,
                                         device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"s": [st(p) for p in params], "t": 0}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor], lr: float):
        c = self.cfg
        grads, gnorm = _clipped(grads, c, self.sharding)
        t = state["t"] + 1
        beta2 = 1.0 - torch.tensor(t, dtype=torch.float32) ** -0.8
        new_s = []
        for i, (p, gl, sl) in enumerate(zip(params, grads, state["s"])):
            beta2 = beta2.to(p.device)
            dims = self._dim_axes(i, p.ndim)
            glob = [n * (mesh_mod.size(a) if a else 1)
                    for n, a in zip(p.shape, dims)]

            def mean(x, dim, axes, n):
                """The mean over a dim sharded over ``axes``: the local
                sum, summed over the axes, over the global size."""
                return _psum(x.sum(dim), axes) / float(n)
            g = gl.float()
            g2 = g * g + c.adafactor_eps1
            if p.ndim >= 2:
                r = beta2 * sl["r"] + (1 - beta2) * mean(g2, -1, dims[-1],
                                                         glob[-1])
                cc = beta2 * sl["c"] + (1 - beta2) * mean(g2, -2, dims[-2],
                                                          glob[-2])
                # v̂ = r ⊗ c / mean(r)
                r_mean = mean(r, -1, dims[-2], glob[-2])
                denom = torch.sqrt(r[..., :, None] * cc[..., None, :]
                                   / torch.clamp(r_mean[..., None, None],
                                                 min=c.adafactor_eps1))
                u = g / torch.clamp(denom, min=1e-30)
                new_s.append({"r": r, "c": cc})
            else:
                v = beta2 * sl["v"] + (1 - beta2) * g2
                u = g / torch.sqrt(v + c.adafactor_eps1)
                new_s.append({"v": v})
            # per-matrix RMS clip (mean of u² over one layer's matrix)
            lead = 1 if p.ndim >= 3 and p.shape[0] > 1 else 0
            n = float(math.prod(glob[lead:]))
            sq = _psum((u * u).sum(tuple(range(lead, p.ndim)), keepdim=True),
                       tuple(sorted(set(a for ax in dims for a in ax))))
            rms = torch.sqrt(sq / n)
            u = u / torch.clamp(rms / c.adafactor_clip, min=1.0)
            p32 = p.float()
            p.copy_(p32 - lr * (u + c.weight_decay * p32))
        return params, {"s": new_s, "t": t}, {"grad_norm": gnorm}


def make(name: str, cfg: OptConfig, sharding: Optional[Sharding] = None
         ) -> "AdamW | SGDM | Adafactor":
    table = {"adamw": AdamW, "adafactor": Adafactor, "sgdm": SGDM}
    return table[name](cfg, sharding)
