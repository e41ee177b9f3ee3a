"""Host-sharded data pipeline with background prefetch and an exact cursor.
Counterpart of ``repro.data.pipeline``.

The pipeline is an iterator of host (CPU) torch batches: host ``h`` of
``H`` gets rows ``[h * b, (h + 1) * b)`` of the global batch
``data.synthetic.batch_at(cfg, step)``, ``b = global_batch / H``, so a
rank's rows are the same whatever the world's size, and world rank ``r``
holds the rows JAX's ``P(("pod", "data"))`` sharding gives device ``r``.
Its state is one integer, the step cursor, because a batch is a pure
function of it.  One prefetch thread makes the next batches while the
card computes.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import torch

from repro_torch.data.synthetic import DataConfig, batch_at


def host_batch(cfg: DataConfig, step: int, host: int = 0,
               num_hosts: int = 1) -> dict:
    """Host ``host``'s contiguous slice of the global batch at ``step``,
    as torch tensors."""
    if cfg.global_batch % num_hosts:
        raise ValueError(f"a global batch of {cfg.global_batch} does not "
                         f"split over {num_hosts} hosts")
    per = cfg.global_batch // num_hosts
    return {k: torch.from_numpy(v[host * per:(host + 1) * per])
            for k, v in batch_at(cfg, step).items()}


class Pipeline:
    def __init__(self, cfg: DataConfig, host: int = 0, num_hosts: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.host = host
        self.num_hosts = num_hosts
        self._step = start_step
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -------- cursor (checkpointed) --------
    def cursor(self) -> int:
        return self._step

    def seek(self, step: int) -> None:
        self._drain()
        self._step = step

    # -------- iteration --------
    def _producer(self, start: int) -> None:
        s = start
        while not self._stop.is_set():
            b = host_batch(self.cfg, s, self.host, self.num_hosts)
            try:
                self._q.put((s, b), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def _drain(self) -> None:
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None
            self._stop = threading.Event()

    def close(self) -> None:
        """Stop the prefetch thread."""
        self._drain()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._prefetch <= 0:
            b = host_batch(self.cfg, self._step, self.host, self.num_hosts)
            self._step += 1
            return b
        if self._thread is None:
            self._q = queue.Queue(maxsize=self._prefetch)
            self._thread = threading.Thread(
                target=self._producer, args=(self._step,), daemon=True)
            self._thread.start()
        s, b = self._q.get()
        self._step = s + 1
        return b
