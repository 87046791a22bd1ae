"""The port's recorder: per-stage wall-clock sums, spans and work counters
(grown from a copy of fasim_tpu/profiling.py; one `STAGES` for the port).

The reference's only tracing is one wall-clock print (SURVEY.md §5,
Fasim-LongTarget.cpp:113-115); this tracks the stage split of a run.

  * Sums.  `timer(name)` adds its block's `perf_counter` seconds to
    `name` and one to `n_<name>`; the host candidate stage runs on a pool,
    so its time is busy-seconds (a sum over threads).  Always on.
  * Counters.  `count(name, n)` adds n to `n_<name>`: the work a stage
    was asked to do (batches, saturated batches, scan and window cells,
    window rows, peaks, winners).  Always on.
  * Spans.  While tracing is on, each `timer` block is also kept as a
    `Span` (name, start and end on the host's Unix clock in ns, the
    clock torch.profiler stamps its events with; thread; its own id and
    its parent's; the job id every span of one `cli.main` call shares;
    the batch index and segment where they apply) and opens
    `torch.profiler.record_function("fasim.<name>")` on its thread, so
    that a profiler's record holds the program's ranges and the kernels
    launched inside them.  A span's parent is the innermost span open
    on its thread, or the one given (`parent=`, `spanned`): thread pools
    carry no context.

Tracing is on while a torch.profiler session that records host activity
was running at `start_run()` and still runs, or while FASIM_TRACE names a
file; then `cli.run` writes the job's spans there as a Chrome trace
(chrome://tracing, Perfetto).  Off, a `timer` costs what the sums cost.

`report()` returns a dict (the CLI prints it as one JSON line on stderr
under FASIM_PROFILE=1 or `--tpu-profile true`): every key but `wall` and
those starting with `n_` is seconds.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict


class Span:
    """One timed block of one thread, on the host's Unix clock (ns)."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "id", "parent",
                 "job", "batch", "segment")

    def __init__(self, name: str, sid: int, parent: Span | None,
                 job: int | None = None, batch: int | None = None,
                 segment: int | None = None) -> None:
        self.name = name
        self.id = sid
        self.parent = parent.id if parent is not None else 0
        self.job = job if job is not None else (
            parent.job if parent is not None else 0)
        self.batch = batch if batch is not None else (
            parent.batch if parent is not None else None)
        self.segment = segment
        self.thread = threading.get_native_id()
        self.start_ns = self.end_ns = 0


def _profiler_records_host() -> bool:
    """Whether a torch.profiler session that records host (CPU) activity
    is running.  torch keeps no registry of its sessions, so the running
    one is looked for among the live objects: one gc pass, only while a
    profiler is on."""
    import sys

    ap = sys.modules.get("torch.autograd.profiler")
    if ap is None or not getattr(ap, "_is_profiler_enabled", False):
        return False
    import gc

    return any(isinstance(o, ap.profile) and o.entered and o.use_cpu
               and getattr(o, "kineto_results", None) is None
               for o in gc.get_objects())


def _profiler_on() -> bool:
    import sys

    ap = sys.modules.get("torch.autograd.profiler")
    return ap is not None and bool(getattr(ap, "_is_profiler_enabled",
                                           False))


class StageTimers:
    def __init__(self) -> None:
        self._t: dict[str, float] = defaultdict(float)
        self._n: dict[str, int] = defaultdict(int)
        self._c: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._wall0: float | None = None
        self._spans: list[Span] = []
        self._ids = itertools.count(1)
        self._jobs = itertools.count(1)
        self._local = threading.local()
        self._profiled = False
        self.tracing = False

    def start_run(self) -> None:
        """Reset the sums, counters and spans; tracing turns on if a
        torch.profiler session records host activity now."""
        with self._lock:
            self._t.clear()
            self._n.clear()
            self._c.clear()
            self._spans.clear()
            self._wall0 = time.perf_counter()
        self._profiled = _profiler_records_host()
        self._refresh()
        if self._profiled:
            # torch's first range of a session costs ~1 ms more than the
            # next: pay it here, not in the job's first span
            from torch.profiler import record_function

            with record_function("fasim.tracing"):
                pass

    def _refresh(self) -> None:
        self.tracing = bool(os.environ.get("FASIM_TRACE")) or (
            self._profiled and _profiler_on())

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self._t[name] += dt
            self._n[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter `n_<name>` of report()."""
        with self._lock:
            self._c[name] += int(n)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Span | None:
        """The innermost span open on this thread (None while tracing is
        off): the parent to hand to work that runs on another thread."""
        if not self.tracing:
            return None
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def timer(self, name: str, parent: Span | None = None,
              batch: int | None = None, segment: int | None = None,
              job: int | None = None):
        """Sum the block's seconds under `name`; while tracing is on, keep
        it as a span too (yielded; None otherwise)."""
        if not self.tracing:
            t0 = time.perf_counter()
            try:
                yield None
            finally:
                self.add(name, time.perf_counter() - t0)
            return
        from torch.profiler import record_function

        stack = self._stack()
        up = parent if parent is not None else (stack[-1] if stack
                                                else None)
        span = Span(name, next(self._ids), up, job, batch, segment)
        with record_function("fasim." + name):
            t0 = time.perf_counter()
            span.start_ns = time.time_ns()
            stack.append(span)
            try:
                yield span
            finally:
                stack.pop()
                span.end_ns = time.time_ns()
                dt = time.perf_counter() - t0
                with self._lock:
                    self._t[name] += dt
                    self._n[name] += 1
                    self._spans.append(span)

    def spanned(self, name: str, fn, batch: int | None = None,
                segment: int | None = None):
        """`fn` wrapped to run inside the span `name` on whichever thread
        calls it, with this thread's current span as its parent."""
        parent = self.current()

        def run(*args, **kwargs):
            with self.timer(name, parent=parent, batch=batch,
                            segment=segment):
                return fn(*args, **kwargs)

        return run

    @contextlib.contextmanager
    def job(self):
        """The `job` span of one `cli.main` call; every span under it
        shares its job id.  Tracing is decided anew at its start; at its
        end, under FASIM_TRACE, the job's spans are written there."""
        self._refresh()
        jid = next(self._jobs)
        try:
            with self.timer("job", job=jid):
                yield jid
        finally:
            path = os.environ.get("FASIM_TRACE")
            if path and self.tracing:
                self.write_chrome_trace(path, self.spans(jid))
            self._refresh()

    def spans(self, job: int | None = None) -> list[Span]:
        """The spans recorded since start_run (of one job if given)."""
        with self._lock:
            return [s for s in self._spans if job is None or s.job == job]

    @staticmethod
    def write_chrome_trace(path: str, spans: list[Span]) -> None:
        """The spans as Chrome-trace complete events (microseconds)."""
        pid = os.getpid()
        names = {t.native_id: t.name for t in threading.enumerate()}
        events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"name": names.get(tid, str(tid))}}
                  for tid in sorted({s.thread for s in spans})]
        events += [{"name": s.name, "ph": "X", "pid": pid, "tid": s.thread,
                    "ts": s.start_ns / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent, "job": s.job,
                             "batch": s.batch, "segment": s.segment}}
                   for s in spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

    def report(self) -> dict:
        with self._lock:
            out = {k: round(v, 3) for k, v in sorted(self._t.items())}
            out.update({f"n_{k}": v for k, v in sorted(self._n.items())})
            out.update({f"n_{k}": v for k, v in sorted(self._c.items())})
            if self._wall0 is not None:
                out["wall"] = round(time.perf_counter() - self._wall0, 3)
        return out


STAGES = StageTimers()
