"""The window kernels' share of their roofline, in percent: the least time
of the window cells the candidate stage asked for (n_window_cells, with
prewarm's n_window_cells_prewarm, from the program's counters over the
window: each window's rlen columns by the query rows [off, max(mreal,
m)), counted from the dispatch's specs, whatever kernel sweeps them), at
5 int32 operations a cell against portbench.yardstick.INT32_OPS, over
the device seconds of the window kernels in the trace (K3
`window_fwd_kernel`, K4 and K6 `window_pairs_kernel` instances, by name,
as window_kernels_s_per_mbp finds them).  None where the program does
not count the cells or the trace holds no window kernel.  Kernels layer;
moves device_s_per_mbp."""

import re

from portbench.yardstick import INT32_OPS

# the least integer operations a window cell needs on sm_90, a frozen copy
# of chip_smoke.WINDOW_OPS_PER_CELL: the DP's 6 in the s16x2 forms, which
# do two cells an operation, and 2 for the column's (max, row) key
WINDOW_OPS_PER_CELL = 6 / 2 + 2
KERNELS = re.compile(r"\bwindow_")


def read(rec: dict):
    t = rec["trace"]
    stages = rec.get("stages") or {}
    if not t or "n_window_cells" not in stages:
        return None
    secs = sum(s for name, s in t["kernels"].items() if KERNELS.search(name))
    if secs <= 0:
        return None
    cells = stages["n_window_cells"] + stages.get("n_window_cells_prewarm", 0)
    return 100.0 * WINDOW_OPS_PER_CELL * cells / INT32_OPS / secs
