"""Per-stage wall-clock timers (a copy of the JAX package's
``utils/timers.py``).

The reference prints only the total elapsed time; ``run_simulation`` keeps
the seconds of each stage (mesh, stokes, transport, metrics, mu_eff,
mesh_io) with this.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

__all__ = ["StageTimer"]


class StageTimer:
    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def record(self, name, seconds):
        self.times[name] = self.times.get(name, 0.0) + seconds

    def summary(self):
        return dict(sorted(self.times.items(), key=lambda kv: -kv[1]))

    def report(self, prefix=""):
        for name, t in self.summary().items():
            print(f"{prefix}{name}: {t:.3f}s")
