"""AdamW with global-norm clipping.  Counterpart of the replicated-parameter
parts of ``repro.train.optimizer`` (``OptConfig``, ``global_norm``,
``clip_by_global_norm``, ``AdamW``) and of its flat-space AdamW for the
ZeRO-1 shards (``flat_adamw_init``, ``flat_adamw_update``).

Parameters are replicated over the data axis (fp32, or bf16 working
copies), so the global norm needs no collective.  Both updates run one
elementwise function, ``adamw_math``, in the JAX package's operation
order and in fp32, whatever the parameter's dtype; that is what makes the
owner-sharded update bit-identical to the replicated one from the same
bf16 parameters.  Updates are written in place to save a copy of each
tensor; ``AdamW.update`` returns the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


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


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """fp32 L2 norm over every leaf, summed in leaf order."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + g.float().square().sum()
    return total.sqrt()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    norm = global_norm(grads)
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
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

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
        if c.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, c.grad_clip)
        else:
            gnorm = global_norm(grads)
        t = state["t"] + 1
        bc1, bc2 = _bias_corrections(c, t)
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            p32 = p.float()
            adamw_math(p32, g, m, v, bc1, bc2, lr, c)
            if p32 is not p:
                p.copy_(p32)
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


def make(name: str, cfg: OptConfig) -> AdamW:
    if name != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    return AdamW(cfg)
