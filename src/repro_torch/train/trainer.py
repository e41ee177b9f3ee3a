"""The training loop and its per-step metrics.  Counterpart of
``repro.train.trainer`` without checkpointing or preemption handling
(later slices).

Local SGD: with ``sync_every > 1`` the parameters are averaged over the
``pod`` axis after every ``sync_every``-th step
(``train_step.local_sgd_sync``; nothing to do without a pod axis), as in
the JAX trainer.  The mean is part of that step's timed region and its
record says ``synced``.

Each step is timed on the host clock and ends with the device synchronised
(reading the metrics waits for the step), so ``step_s`` and ``tok_per_s``
are the step's wall time on the device it ran on.  On CUDA the record also
holds the peak of allocated device memory during the step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import torch

from repro_torch.train import schedule as sched_mod
from repro_torch.train import train_step as ts


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    accum: int = 1              # microbatches per step (classic accumulation)
    sync_every: int = 1         # local-SGD pod-sync period
    schedule: sched_mod.ScheduleConfig = dataclasses.field(
        default_factory=sched_mod.ScheduleConfig)


class Trainer:
    def __init__(self, setup: ts.TrainSetup, cfg: TrainerConfig,
                 data: Iterable[dict], state: Optional[dict] = None):
        self.setup = setup
        self.cfg = cfg
        self.data = data
        self.state = state
        self.step_fn = None
        self.sync_fn = None
        self.history: list[dict] = []

    def run(self, seed: int = 0) -> dict:
        cfg = self.cfg
        if self.state is None:
            self.state = ts.init_state(self.setup, seed)
        if self.step_fn is None:
            self.step_fn = ts.make_step(self.setup, accum=cfg.accum)
        if cfg.sync_every > 1 and self.sync_fn is None:
            self.sync_fn = ts.local_sgd_sync(self.setup)
        cuda = self.setup.device.type == "cuda"
        it = iter(self.data)
        for step in range(self.state["step"], cfg.total_steps):
            batch = next(it)
            lr = sched_mod.lr_at(cfg.schedule, step)
            if cuda:
                torch.cuda.synchronize(self.setup.device)
                torch.cuda.reset_peak_memory_stats(self.setup.device)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch, lr)
            synced = self.sync_fn is not None \
                and (step + 1) % cfg.sync_every == 0
            if synced:
                self.state = self.sync_fn(self.state)
            rec = {k: v.item() for k, v in metrics.items()}
            if cuda:
                torch.cuda.synchronize(self.setup.device)
            dt = time.perf_counter() - t0
            rec.update(step=step + 1, lr=lr, step_s=dt,
                       tok_per_s=rec["tokens"] / dt, synced=synced)
            if cuda:
                rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(
                    self.setup.device) / 2**30
            self.history.append(rec)
            if cfg.log_every and (step + 1) % cfg.log_every == 0:
                mem = (f"  peak {rec['peak_mem_gb']:.2f} GiB"
                       if cuda else "")
                print(f"step {rec['step']:>6d}  loss {rec['loss']:.4f}  "
                      f"gnorm {rec['grad_norm']:.3f}  lr {lr:.2e}  "
                      f"{rec['step_s'] * 1e3:.1f} ms  "
                      f"{rec['tok_per_s']:,.0f} tok/s{mem}", flush=True)
        return self.state
