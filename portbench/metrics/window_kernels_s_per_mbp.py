"""Device seconds of the candidate stage's window kernels per million DNA
bases of the window: K3 (`window_fwd_kernel`, csrc/window_fwd.cu), and K4
and K6 (`window_pairs_kernel` instances of csrc/window_pairs.cuh, under
window_gen.cu and window_v1.cu), by their names in the trace.  Kernels
layer; moves device_s_per_mbp."""

import re

# the window kernels' names as CUPTI gives them (template instances of
# window_fwd_kernel and window_pairs_kernel)
KERNELS = re.compile(r"\bwindow_")


def read(rec: dict):
    t = rec["trace"]
    if not t or rec["bases"] <= 0:
        return None
    secs = sum(s for name, s in t["kernels"].items() if KERNELS.search(name))
    if secs <= 0:
        return None
    return secs / (rec["bases"] / 1e6)
