"""What a traced window's torch.profiler record says: the cards' busy
time, their kernels by name, and the idle gaps by what the host was doing.

The window is the span of the harness's `portbench.window` annotation in
the profiler's own clock.  Device events are the kernels, copies and sets
CUPTI records on the cards, each with its card's index; a card's busy
time is the union of its own intervals inside the window, and the
record's busy time is the sum of the cards' (card-seconds: on one card,
the union).  A gap is a stretch of the window in which no card is busy,
labelled by the innermost host event that covers its middle: a torch
operation, else the harness's own annotation of a job (inside the
program's call, in code that runs no torch operation: NumPy, the native
C++ stages, Python).  The device-side mirrors of the annotations are not
device work and are left out.
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
            dev.append((a, b, e.name(), e.device_index()))
        else:
            host.append((a, b, e.name()))
    return dev, host


def read(prof) -> dict | None:
    """{"busy_s", "busy_s_by_card": {card index: seconds}, "window_s",
    "kernels": {name: seconds, summed over the cards}, "gaps": [(label,
    seconds)] longest first}, or None when the record has no window and
    no device work.  A record of the device alone (no host events: the
    profiler started after set-up's last device work and stopped after
    the window's) has no annotation; its window is then the span of its
    device events."""
    dev, host = _events(prof)
    wins = [(a, b) for a, b, n in host if n == WINDOW]
    if wins:
        w0, w1 = wins[0]
    elif dev:
        w0, w1 = min(a for a, _, _, _ in dev), max(b for _, b, _, _ in dev)
    else:
        return None
    kernels: dict[str, float] = {}
    by_card: dict[int, list] = {}
    for a, b, name, card in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-9
        by_card.setdefault(card, []).append((a, b))
    busy = {card: _union(spans, w0, w1)[0]
            for card, spans in sorted(by_card.items())}
    _, gaps = _union([s for spans in by_card.values() for s in spans],
                     w0, w1)
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"busy_s": sum(busy.values()) * 1e-9,
            "busy_s_by_card": {c: ns * 1e-9 for c, ns in busy.items()},
            "window_s": (w1 - w0) * 1e-9, "kernels": kernels,
            "gaps": [(_label(host, (a + b) // 2), (b - a) * 1e-9)
                     for a, b in gaps[:10]]}


def _union(spans: list, w0: int, w1: int) -> tuple[int, list]:
    """(the nanoseconds the union of `spans` covers, the gaps of [w0, w1)
    it leaves); every span lies inside [w0, w1)."""
    busy = 0
    gaps = []
    cur = w0
    for a, b in sorted(spans):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    return busy, gaps


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
