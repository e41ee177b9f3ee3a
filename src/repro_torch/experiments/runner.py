"""Runner + ResultStore: execute sweeps, persist, and resume by spec hash.
Counterpart of ``repro.experiments.runner``.

The store is JSON-lines (one ``Result.to_json()`` per line, append-only),
so an interrupted 200-setup sweep resumes where it stopped, a re-run with
an enlarged grid only evaluates the new cells, and the file doubles as the
canonical source for ``BENCH_*.json`` trajectory rows.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Iterable, Optional

from repro_torch.experiments.backend import Backend, Result
from repro_torch.experiments.spec import ExperimentSpec, Grid


class ResultStore:
    """Append-only JSON-lines persistence keyed by ``spec_hash``.

    Later rows for the same hash win (a failed cell can be re-run and the
    fresh result supersedes the error row on load).
    """

    def __init__(self, path: str):
        self.path = path

    def load(self) -> dict[str, Result]:
        out: dict[str, Result] = {}
        if not os.path.exists(self.path):
            return out
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                    out[d["spec_hash"]] = Result.from_json(d)
                except (json.JSONDecodeError, KeyError):
                    continue  # tolerate a torn final line after a crash
        return out

    def append(self, result: Result) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(result.to_json(), sort_keys=True) + "\n")


class Runner:
    """Evaluate specs through a backend, skipping completed ones.

    ``resume=True`` (default, when a store is given) skips any spec whose
    hash already has an ``ok`` result in the store — errors and misses are
    retried.  Returns results in input-spec order regardless of what came
    from the store vs. the backend.
    """

    def __init__(self, backend: Backend, store: Optional[ResultStore] = None,
                 resume: bool = True,
                 progress: Optional[Callable[[int, int, Result],
                                             None]] = None):
        self.backend = backend
        self.store = store
        self.resume = resume
        self.progress = progress

    def run(self, specs: Iterable[ExperimentSpec] | Grid) -> list[Result]:
        if isinstance(specs, Grid):
            specs = specs.specs()
        specs = list(specs)
        done = (self.store.load() if self.store and self.resume else {})
        out: list[Result] = []
        for i, spec in enumerate(specs):
            h = spec.spec_hash()
            cached = done.get(h)
            if cached is not None and cached.ok:
                out.append(cached)
            else:
                r = self.backend.run(spec)
                if self.store is not None:
                    self.store.append(r)
                out.append(r)
            if self.progress is not None:
                self.progress(i + 1, len(specs), out[-1])
        return out
