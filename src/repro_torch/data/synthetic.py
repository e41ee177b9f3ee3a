"""Deterministic synthetic LM data with learnable structure.

Tokens follow a noisy fixed random permutation chain:
``tok[t+1] = perm[tok[t]]`` with probability ``1 - noise`` else uniform —
a bigram structure any LM drives to ``H ≈ noise·log V`` quickly, so example
runs show real learning.  Every batch is a pure function of
``(seed, step, host)``: restart-exact, no data-induced stragglers
(DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.15
    kind: str = "markov"          # "markov" | "uniform"


def _perm(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 1_000_003)
    return rng.permutation(cfg.vocab)


def batch_at(cfg: DataConfig, step: int, host: int = 0,
             num_hosts: int = 1) -> dict:
    """The host's slice of the global batch at ``step`` (tokens, labels)."""
    assert cfg.global_batch % num_hosts == 0
    b = cfg.global_batch // num_hosts
    rng = np.random.default_rng(
        (cfg.seed * 1_000_033 + step) * 131 + host)
    if cfg.kind == "uniform":
        toks = rng.integers(0, cfg.vocab, (b, cfg.seq_len + 1),
                            dtype=np.int64)
    else:
        perm = _perm(cfg)
        toks = np.empty((b, cfg.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        noise = rng.random((b, cfg.seq_len)) < cfg.noise
        rand = rng.integers(0, cfg.vocab, (b, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
