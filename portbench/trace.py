"""What a traced window's torch.profiler record says: the device's busy
time, its kernels by name, and its idle gaps by what the host was doing.

The window is the span of the harness's `portbench.window` annotation in
the profiler's own clock.  Device events are the kernels, copies and sets
CUPTI records on the card; busy time is the union of their intervals
inside the window.  A gap is labelled by the innermost host event that
covers its middle: a torch operation, else the harness's own annotation
of a job (inside the program's call, in code that runs no torch
operation: NumPy, the native C++ stages, Python).  The device-side
mirrors of the annotations are not device work and are left out.
"""

from __future__ import annotations

WINDOW = "portbench.window"
JOB = "portbench.job"


def _events(prof):
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            mirror = getattr(e, "is_user_annotation", lambda: False)()
            if mirror or e.name().startswith("portbench."):
                # the device-side mirror of a host annotation: the span
                # between its first and last kernel, not device work
                continue
            dev.append((a, b, e.name()))
        else:
            host.append((a, b, e.name()))
    return dev, host


def read(prof) -> dict | None:
    """{"busy_s", "window_s", "kernels": {name: seconds}, "gaps":
    [(label, seconds)] longest first}, or None when the record has no
    window and no device work.  A record of the device alone (no host
    events: the profiler started after set-up's last device work and
    stopped after the window's) has no annotation; its window is then
    the span of its device events."""
    dev, host = _events(prof)
    wins = [(a, b) for a, b, n in host if n == WINDOW]
    if wins:
        w0, w1 = wins[0]
    elif dev:
        w0, w1 = min(a for a, _, _ in dev), max(b for _, b, _ in dev)
    else:
        return None
    kernels: dict[str, float] = {}
    spans = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-9
        spans.append((a, b))
    spans.sort()
    busy = 0
    gaps = []
    cur = w0
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "kernels": kernels,
            "gaps": [(_label(host, (a + b) // 2), (b - a) * 1e-9)
                     for a, b in gaps[:10]]}


def _label(host, t: int) -> str:
    """The innermost host event covering time t."""
    best = None
    for a, b, name in host:
        if a <= t < b and name != WINDOW and (best is None or b - a < best[1]):
            best = (name, b - a)
    if best is None:
        return "between the harness's jobs"
    if best[0] == JOB:
        return "in cli.main, outside torch operations (NumPy, native, Python)"
    return best[0]
