"""The card's peaks and the least work a scan needs: the arithmetic the
roofline metrics divide by.

NVIDIA H100 SXM (NVIDIA's data sheet; the rates assume the full 700 W
power limit): 132 SMs, 64 INT32 lanes an SM, 1,980 MHz the highest SM
clock, HBM3 at 3.35 TB/s.  The operation counts are frozen copies of the
port's own (chip_smoke.scan_ops_per_cell).
"""

from __future__ import annotations

SMS = 132
INT32_LANES = 64
SM_CLOCK_HZ = 1.98e9
INT32_OPS = SMS * INT32_LANES * SM_CLOCK_HZ  # 1.673e13 int32 ops/s
MEM_BPS = 3.35e12  # bytes/s


def scan_ops_per_cell(m16: int, n: int) -> float:
    """The least integer operations one DP cell of the scan needs on
    sm_90: the score 1 (a PRMT of a per-row byte table by the column's
    code), H - 16 once for both gaps 1, E and F one __viaddmax each, H 2
    (__viaddmax_relu of diag + s and E, then a max with F), the column
    max 1; 7 in all.  Where every H fits in 16 bits the s16x2 forms do
    two cells an operation: 3.5.  A local score is at most 5 a row and 5
    a column, 5 * min(m16, n), so 3.5 while that is <= 32767."""
    return 7 / 2 if 5 * min(m16, n) <= 32767 else 7


def scan_least_seconds(query_len: int, transforms: int, bases: int,
                       segments: int, longest: int) -> tuple[float, str]:
    """The least time the column-max scan of `bases` DNA bases (segment
    overlaps included, `segments` segments, the longest `longest`) can
    take against a query of `query_len`, and which term binds it.  Every
    (transform, query row, base) cell is counted once: on ACGT inputs the
    threshold and the column maxima come from one DP.  Bytes: each base
    and query byte read once, a column maximum byte a (transform, base)
    and a threshold word a (segment, transform) written once."""
    m16 = query_len + (-query_len) % 16
    ops = scan_ops_per_cell(m16, longest) * transforms * query_len * bases
    nbytes = bases + query_len + transforms * bases + 4 * transforms * segments
    t_ops = ops / INT32_OPS
    t_bytes = nbytes / MEM_BPS
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
