"""Card-seconds of busy time per million DNA bases of the window's jobs:
each card's union of the kernel, copy and set intervals torch.profiler's
CUPTI record holds for the window, summed over the cards (on one card,
the union), over the bases the jobs scanned.  The card time a base
costs, which sets how much DNA a card scans a second when it is kept
fed.  End-to-end; every run records the cards' work."""


def read(rec: dict):
    t = rec["trace"]
    if not t or t["busy_s"] <= 0 or rec["bases"] <= 0:
        return None
    return t["busy_s"] / (rec["bases"] / 1e6)
