"""NumPy reference (golden) implementations of the two hot DP passes.

Both passes are affine-gap local alignment (gap open 16 / extend 4) of the
full RNA query against one transformed DNA segment:

  * threshold pass  -> global max score            (stats.h calc_score_once)
  * scan pass       -> per-ref-position column max (sswNew.cpp
                       sw_sse2_byte_once / ssw_pre_align)

Exactness argument (why plain int32 DP reproduces the SSE2 kernels):

1. With these scoring parameters a gap directly following a gap in the other
   direction is strictly dominated (cost 2*open vs. one mismatch), so the
   SWPS3 "lazy-F, don't update E" variant computes cell values identical to
   the textbook recurrence.
2. u8 saturation only distorts cells whose true value reaches BYTE_SAT=251
   (bias 4, cap 255).  The threshold kernel escalates to the exact 16-bit
   kernel exactly in that case (stats.h:948-951), so its result equals the
   true int32 max.  The scan kernel *breaks out* of the reference loop the
   first time the running max reaches 251 — before recording that column
   (sswNew.cpp:384-386) — so every *recorded* column precedes any saturated
   cell and is exact; later columns are left at 0.  ssw_pre_align's own word
   escalation (sswNew.cpp:1348) is dead code because byte column maxima never
   exceed 251 < 255.

Validated against an instrumented build of the reference kernels
(oracle/harness.cpp) on bundled and random data.
"""

from __future__ import annotations

import numpy as np

from ..config import BYTE_SAT, GAP_EXTEND, GAP_OPEN


def _column_step(Hprev: np.ndarray, Eprev: np.ndarray, s_col: np.ndarray,
                 go: int, ge: int) -> tuple[np.ndarray, np.ndarray]:
    """One ref-position update of the SW column, vectorized over the query.

    H/E are length-M int32 arrays for the previous ref position.  The
    vertical-gap F within the column is resolved with a prefix max over
    (tmp[i] + i*ge), which is exact because an F value routed through an H
    cell re-pays the gap-open and can never beat direct extension.
    """
    M = Hprev.shape[0]
    E = np.maximum(Eprev - ge, Hprev - go)
    diag = np.empty_like(Hprev)
    diag[0] = 0
    diag[1:] = Hprev[:-1]
    tmp = np.maximum(np.maximum(diag + s_col, E), 0)
    # Gap of length L costs go + (L-1)*ge (the kernels charge `go` for the
    # first gap character):  F[i] = max_{k<i} (tmp[k] - go - (i-1-k)*ge)
    idx = np.arange(M, dtype=np.int64)
    run = np.maximum.accumulate(tmp.astype(np.int64) + idx * ge)
    F = np.empty(M, dtype=np.int64)
    F[0] = np.iinfo(np.int64).min // 2
    F[1:] = run[:-1] - go - (idx[1:] - 1) * ge
    H = np.maximum(tmp, F).astype(np.int32)
    return H, E


def sw_colmax(query_idx: np.ndarray, ref_idx: np.ndarray, mat: np.ndarray,
              go: int = GAP_OPEN, ge: int = GAP_EXTEND,
              byte_break: bool = True, lanes: int = 16) -> np.ndarray:
    """Column maxima of the SW matrix, with the reference's byte-kernel
    break rule applied when byte_break (scan pass).  Returns int32[refLen].

    Pad emulation: the striped byte kernel rounds the query up to
    ceil(M/16)*16 positions whose profile entries are `bias`, i.e. score 0
    against every ref char (qP_byte, sswNew.cpp:195).  These phantom tail
    cells carry peak values diagonally at constant height and are included
    in vMaxColumn, so they must be modeled for bit parity.
    """
    M, N = len(query_idx), len(ref_idx)
    pad = (-M) % lanes
    colmax = np.zeros(N, dtype=np.int32)
    H = np.zeros(M + pad, dtype=np.int32)
    E = np.zeros(M + pad, dtype=np.int32)
    prof = np.vstack([mat[query_idx],
                      np.zeros((pad, mat.shape[1]), dtype=mat.dtype)])
    running = 0
    for j in range(N):
        H, E = _column_step(H, E, prof[:, ref_idx[j]], go, ge)
        cm = int(H.max(initial=0))
        if byte_break and cm > running and cm >= BYTE_SAT:
            break  # column j itself is NOT recorded (sswNew.cpp:386)
        if cm > running:
            running = cm
        colmax[j] = cm
    return colmax


def sw_max(query_idx: np.ndarray, ref_idx: np.ndarray, mat: np.ndarray,
           go: int = GAP_OPEN, ge: int = GAP_EXTEND) -> int:
    """Exact global SW max (threshold pass; byte->word escalation makes the
    reference exact, see module docstring)."""
    M = len(query_idx)
    H = np.zeros(M, dtype=np.int32)
    E = np.zeros(M, dtype=np.int32)
    prof = mat[query_idx]
    best = 0
    for j in range(len(ref_idx)):
        H, E = _column_step(H, E, prof[:, ref_idx[j]], go, ge)
        m = int(H.max(initial=0))
        if m > best:
            best = m
    return best
