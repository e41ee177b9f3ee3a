"""The training loop: per-step metrics, checkpoints and preemption.
Counterpart of ``repro.train.trainer``.

Checkpoints (``ckpt_dir``): the trainer restores the newest complete
checkpoint there before its first step and moves the data to its cursor
(``seek``), saves every ``ckpt_every`` steps (0: only at the end), keeps
the newest ``keep_ckpts``, and saves once more at the end.  Saving is a
collective (``checkpoint.manager``: each rank writes its slices of the
FSDP and TP leaves into the JAX package's global layout), so every rank
runs it; it falls
outside each step's timed region.  The newest checkpoint restores at
another world, FSDP degree or ``tp`` too.

Preemption: ``run`` traps SIGTERM and SIGINT for its duration.  A signal
sets ``stop_requested``; the step under way finishes, the trainer saves
it and returns (on several ranks, after the first step that any rank ends
with the flag set).  The handlers in place before ``run`` come back when it
returns.

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
import signal
import time
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from repro_torch.train import schedule as sched_mod
from repro_torch.train import train_step as ts


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    accum: int = 1              # microbatches per step (classic accumulation)
    sync_every: int = 1         # local-SGD pod-sync period
    ckpt_every: int = 0         # 0 = only final
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
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
        self.stop_requested = False
        self.history: list[dict] = []
        self._manager = None
        self._saved_step: Optional[int] = None
        if cfg.ckpt_dir:
            from repro_torch.checkpoint.manager import CheckpointManager
            self._manager = CheckpointManager(cfg.ckpt_dir, setup,
                                              keep=cfg.keep_ckpts)

    def _install_signal_handlers(self) -> dict:
        """Trap SIGTERM and SIGINT; returns the handlers they replace
        (none off the main thread, where signals cannot be trapped)."""
        def handler(signum, frame):
            self.stop_requested = True
        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, handler)
            except ValueError:
                pass
        return old

    def _maybe_restore(self, seed: int) -> None:
        if self._manager is not None:
            restored = self._manager.restore_latest()
            if restored is not None:
                self.state, cursor = restored
                if cursor is not None and hasattr(self.data, "seek"):
                    self.data.seek(cursor)
                return
        if self.state is None:
            self.state = ts.init_state(self.setup, seed)

    def _save(self, step: int) -> None:
        """Save ``step`` unless this run saved it already."""
        if self._manager is None or step == self._saved_step:
            return
        cursor = self.data.cursor() if hasattr(self.data, "cursor") else None
        self._manager.save(step, self.state, cursor)
        self._saved_step = step

    def _stop_agreed(self) -> bool:
        """Did any rank get the signal?  The save is a collective, so every
        rank stops after the same step."""
        if not (dist.is_initialized() and dist.get_world_size() > 1):
            return self.stop_requested
        flag = torch.tensor([int(self.stop_requested)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def run(self, seed: int = 0) -> dict:
        old = self._install_signal_handlers()
        try:
            return self._run(seed)
        finally:
            for sig, h in old.items():
                signal.signal(sig, h)

    def _run(self, seed: int) -> dict:
        cfg = self.cfg
        self._maybe_restore(seed)
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
            if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
                self._save(step + 1)
            if self._stop_agreed():
                print(f"[trainer] preemption signal at step {step + 1}; "
                      f"checkpointing and exiting", flush=True)
                self._save(step + 1)
                return self.state
        self._save(cfg.total_steps)
        return self.state
