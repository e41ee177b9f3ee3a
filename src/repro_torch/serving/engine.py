"""A small batched serving engine on top of prefill and decode.
Counterpart of ``repro.serving.engine``, with its semantics: a static
batch of ``setup.global_batch`` rows, the prompts left-aligned and padded
with token 0 to the longest, every row at the same position ``cur =
max_prompt``; prefill, then one decode step per new token until every
request has its ``max_new`` tokens or its EOS, or the cache is full
(``cur + 1 >= cache_len``).  Sampling reads the logical vocabulary
(``[:, :vocab]``): greedy ``argmax``, or with a temperature the argmax
of ``logits / temperature`` plus Gumbel noise drawn from a seeded
``torch.Generator`` on the host.

Every rank of the mesh runs the same ``generate`` on the same requests:
the logits are global on every rank, so are the tokens.  The Engine
passes only tokens, so it serves no vlm arch (its decode needs
``mrope_positions``; serve one through ``Model.prefill`` and
``Model.decode``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.serving import serve_step as ss


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    out: Optional[list[int]] = None


class Engine:
    def __init__(self, setup: ss.ServeSetup, *, eos_id: int = -1,
                 temperature: float = 0.0, seed: int = 0):
        """Serves ``setup.model``'s parameters (``ss.serve_params`` or
        loaded ones)."""
        if setup.arch.rope == "mrope":
            raise ValueError(
                f"{setup.arch.name}: the Engine passes only tokens, and "
                f"M-RoPE decode needs mrope_positions; serve it through "
                f"Model.prefill and Model.decode")
        self.setup = setup
        self.eos_id = eos_id
        self.temperature = temperature
        self.generator = torch.Generator().manual_seed(seed)
        self._prefill = ss.make_prefill(setup)
        self._decode = ss.make_decode(setup)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        logits = logits[:, :self.setup.arch.vocab]
        if self.temperature <= 0:
            return logits.argmax(-1).cpu().numpy()
        u = torch.rand(logits.shape, generator=self.generator)
        g = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
        return (logits.float().cpu() / self.temperature + g).argmax(
            -1).numpy()

    def generate(self, requests: list[Request]) -> list[Request]:
        """Static-batch generation: the requests padded with dummy ones to
        ``setup.global_batch`` rows, the common prompt region prefilled,
        then decode until every request has ``max_new`` tokens (or its
        EOS) or the cache is full."""
        b = self.setup.global_batch
        if len(requests) > b:
            raise ValueError(f"{len(requests)} requests for a batch of {b}")
        reqs = list(requests) + [Request(rid=-1, prompt=[0], max_new=1)
                                 for _ in range(b - len(requests))]
        max_prompt = max(len(r.prompt) for r in reqs)
        toks = np.zeros((b, max_prompt), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :len(r.prompt)] = r.prompt      # left-aligned
        logits, cache = self._prefill({"tokens": toks})
        cur = np.full((b,), max_prompt, np.int32)
        next_tok = self._sample(logits)
        for r in reqs:
            r.out = []
        max_new = max(r.max_new for r in reqs)
        done = np.zeros((b,), bool)
        for _ in range(max_new):
            for i, r in enumerate(reqs):
                if not done[i]:
                    r.out.append(int(next_tok[i]))
                    if int(next_tok[i]) == self.eos_id or \
                            len(r.out) >= r.max_new:
                        done[i] = True
            if done.all() or cur[0] + 1 >= self.setup.cache_len:
                break
            logits, cache = self._decode(
                cache, {"tokens": next_tok[:, None], "cur_len": cur})
            cur = cur + 1
            next_tok = self._sample(logits)
        return reqs[:len(requests)]
