"""The scan kernels' share of their roofline, in percent: the least time
the window's DP cells need (portbench.yardstick.scan_least_seconds: 48
transforms x the query's length x the DNA bases scanned, each cell once,
at 3.5 int32 operations a cell against 1.673e13 op/s, or its bytes at
3.35e12 B/s) over the device time of the scan kernels in the trace.
Kernels layer (csrc/scan.cu K1, csrc/scan16.cu K7, csrc/scan_codes.cu
K5); moves device_s_per_mbp.  The scan's escalation reruns count in the
kernels' time and not in the least work."""

import re

from portbench.yardstick import scan_least_seconds

# the scan kernels' names as CUPTI gives them (template instances of
# scan_colmax_kernel, scan16_kernel, scan_codes_kernel)
KERNELS = re.compile(r"\b(scan_colmax|scan16|scan_codes)")


def read(rec: dict):
    t = rec["trace"]
    if not t:
        return None
    secs = sum(s for name, s in t["kernels"].items() if KERNELS.search(name))
    if secs <= 0:
        return None
    least, _ = scan_least_seconds(rec["query_len"], rec["transforms"],
                                  rec["scanned"], rec["segments"],
                                  rec["longest"])
    return 100.0 * least / secs
