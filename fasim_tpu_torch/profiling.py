"""Per-stage wall-clock accounting for the scan drivers (copy of
fasim_tpu/profiling.py; one `STAGES` for the port).

The reference's only tracing is one wall-clock print (SURVEY.md §5,
Fasim-LongTarget.cpp:113-115); this tracks the stage split of a run:
device scan (dispatch + wait), host candidate stage, and driver residue.
Thread-safe; the host candidate stage runs on a pool, so its time is
accounted as busy-seconds (sum over threads) next to the scan's
wall-clock.

Enable with FASIM_PROFILE=1 (or TpuConfig.profile); `report()` returns a
dict and the CLI prints it as one JSON line on stderr.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimers:
    def __init__(self) -> None:
        self._t: dict[str, float] = defaultdict(float)
        self._n: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._wall0: float | None = None

    def start_run(self) -> None:
        with self._lock:
            self._t.clear()
            self._n.clear()
            self._wall0 = time.perf_counter()

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self._t[name] += dt
            self._n[name] += 1

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def report(self) -> dict:
        with self._lock:
            out = {k: round(v, 3) for k, v in sorted(self._t.items())}
            out.update({f"n_{k}": v for k, v in sorted(self._n.items())})
            if self._wall0 is not None:
                out["wall"] = round(time.perf_counter() - self._wall0, 3)
        return out


STAGES = StageTimers()
