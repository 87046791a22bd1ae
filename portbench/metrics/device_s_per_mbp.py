"""Seconds the card was busy per million DNA bases of the window's jobs:
the union of the kernel, copy and set intervals torch.profiler's CUPTI
record holds for the window, over the bases the jobs scanned.  The card's
own cost of a base, which sets how much DNA one card scans a second when
it is kept fed.  End-to-end; every run records the card's work."""


def read(rec: dict):
    t = rec["trace"]
    if not t or t["busy_s"] <= 0 or rec["bases"] <= 0:
        return None
    return t["busy_s"] / (rec["bases"] / 1e6)
