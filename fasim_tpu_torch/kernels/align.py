"""Golden (exact) emulation of the reference candidate-window aligner.

Reproduces `ssw_align` (sswNew.cpp:1446-1547) bit-for-bit on int32 math:

  * forward striped pass  -> (score, ref_end, read_end)   sw_sse2_byte/word
  * reverse striped pass  -> (ref_begin, read_begin)      terminate = score1
  * banded_sw             -> cigar                        sswNew.cpp:1071-1259

plus `prealign_peaks`, the run-clustering of above-threshold columns done by
Aligner::preAlign (ssw_cpp.cpp:430-578).

Semantics notes (verified against the instrumented reference):

  * The byte kernels escalate to the word kernels when the running max
    reaches 251 (max + bias >= 255, bias 4; sswNew.cpp:607, 1473).  Exact
    int32 DP with the same escalation predicate reproduces both.
  * end_ref is the first column at which the running max strictly improved
    to its final value; end_read is the smallest query index attaining the
    max in that column's H (the striped min-scan, sswNew.cpp:620-629).
  * The reverse pass runs the reversed query prefix against ref columns
    scanned right-to-left and stops at the first column whose column max
    equals score1 (`terminate`, sswNew.cpp:617).
  * ssw_align's fork quirk: score1 = min(forward, reverse) (sswNew.cpp:1518).
  * banded_sw prefers the diagonal on ties (temp1 <= temp2, sswNew.cpp:1148),
    prefers F over E on e1 == f1 ties (:1149), doubles the band until
    max >= score with `max` accumulated across band iterations (:1094-1155),
    and appends a trailing 1M when the traceback's final op isn't M
    (:1229-1238).  A leading 0-length op can be emitted when the first
    traceback move isn't M (e initialized 0, prev_op 'M'; :1161-1218).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import BYTE_SAT, GAP_EXTEND, GAP_OPEN
from .ref import _column_step


@dataclasses.dataclass
class Alignment:
    """Mirror of StripedSmithWaterman::Alignment fields used by the scan
    (ssw_cpp.h; populated by ConvertAlignment, ssw_cpp.cpp:55-94)."""

    sw_score: int = 0
    ref_begin: int = -1
    ref_end: int = -1
    query_begin: int = -1
    query_end: int = -1
    cigar: list = dataclasses.field(default_factory=list)  # [(length, op)]

    @property
    def cigar_string(self) -> str:
        return "".join(f"{l}{op}" for l, op in self.cigar)


def _sw_end_pass(query_idx: np.ndarray, ref_cols, go: int, ge: int,
                 mat: np.ndarray, lanes: int, byte_sat: bool,
                 terminate: int | None):
    """One striped-kernel emulation pass over `ref_cols` (iterable of ref
    codes in scan order).  Returns (max, end_col_index, end_read, saturated).

    end_col_index is the index INTO THE SCAN ORDER of the last strict
    improvement (caller maps it back to a ref position for reverse scans).
    """
    M = len(query_idx)
    pad = (-M) % lanes
    H = np.zeros(M + pad, dtype=np.int32)
    E = np.zeros(M + pad, dtype=np.int32)
    prof = np.vstack([mat[query_idx],
                      np.zeros((pad, mat.shape[1]), dtype=mat.dtype)])
    best = 0
    end_col = -1
    best_H = None
    for k, r in enumerate(ref_cols):
        H, E = _column_step(H, E, prof[:, r], go, ge)
        cm = int(H.max(initial=0))
        if cm > best:
            best = cm
            if byte_sat and best >= BYTE_SAT:
                return best, end_col, None, True
            end_col = k
            best_H = H[:M].copy()
        if terminate is not None and cm == terminate:
            break
    if best_H is None:
        return best, end_col, M - 1, False
    hits = np.flatnonzero(best_H == best)
    end_read = int(hits[0]) if hits.size else M - 1
    return best, end_col, end_read, False


def _banded_sw(ref_idx: np.ndarray, read_idx: np.ndarray, score: int,
               go: int, ge: int, band_width: int, mat: np.ndarray):
    """Exact port of banded_sw (sswNew.cpp:1071-1259).  Returns a list of
    (length, op) cigar tuples or None on traceback error."""
    ref_len, read_len = len(ref_idx), len(read_idx)
    max_sc = 0
    while True:
        width = band_width * 2 + 3
        width_d = band_width * 2 + 1
        h_b = np.zeros(width + 1, dtype=np.int64)
        e_b = np.zeros(width + 1, dtype=np.int64)
        h_c = np.zeros(width + 1, dtype=np.int64)
        # direction[i, d] for row i; malloc'd (uninitialized) in the
        # reference — 0 here maps unvisited cells to the traceback error
        # path, as reading garbage generally would.
        direction = np.zeros((read_len, width_d * 3), dtype=np.int8)
        u = 0
        for i in range(read_len):
            beg = max(0, i - band_width)
            end = min(ref_len - 1, i + band_width)
            edge = min(end + 1, width - 1)
            f = 0
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0
            x0 = max(i - band_width, 0)
            x1 = max(i - 1 - band_width, 0)
            dline = direction[i]
            for j in range(beg, end + 1):
                u = j - x0 + 1
                e = j - x1 + 1
                b = j - 1 - x0 + 1
                d = j - 1 - x1 + 1
                dd = (j - x0) * 3
                temp1 = -go if i == 0 else h_b[e] - go
                temp2 = -ge if i == 0 else e_b[e] - ge
                e_b[u] = temp1 if temp1 > temp2 else temp2
                de = 3 if temp1 > temp2 else 2
                dline[dd + 0] = de
                temp1 = h_c[b] - go
                temp2 = f - ge
                f = temp1 if temp1 > temp2 else temp2
                df = 5 if temp1 > temp2 else 4
                dline[dd + 1] = df
                e1 = e_b[u] if e_b[u] > 0 else 0
                f1 = f if f > 0 else 0
                temp1 = e1 if e1 > f1 else f1
                temp2 = h_b[d] + mat[ref_idx[j], read_idx[i]]
                h_c[u] = temp1 if temp1 > temp2 else temp2
                if h_c[u] > max_sc:
                    max_sc = int(h_c[u])
                dline[dd + 2] = 1 if temp1 <= temp2 else (de if e1 > f1 else df)
            h_b[1:u + 1] = h_c[1:u + 1]
        if max_sc >= score:
            break
        band_width *= 2
    # trace back (sswNew.cpp:1158-1238)
    i = read_len - 1
    j = ref_len - 1
    e = 0
    op = prev_op = "M"
    layer = 2
    ops: list[tuple[int, str]] = []
    while i > 0:
        x = max(i - band_width, 0)
        dcode = int(direction[i, (j - x) * 3 + layer])
        if dcode == 1:
            i -= 1
            j -= 1
            layer = 2
            op = "M"
        elif dcode == 2:
            i -= 1
            layer = 0
            op = "I"
        elif dcode == 3:
            i -= 1
            layer = 2
            op = "I"
        elif dcode == 4:
            j -= 1
            layer = 1
            op = "D"
        elif dcode == 5:
            j -= 1
            layer = 2
            op = "D"
        else:
            return None  # "Trace back error"
        if op == prev_op:
            e += 1
        else:
            ops.append((e, prev_op))
            prev_op = op
            e = 1
    if op == "M":
        ops.append((e + 1, op))
    else:
        ops.append((e, op))
        ops.append((1, "M"))
    ops.reverse()
    return ops


def align_window(query_idx: np.ndarray, ref_idx: np.ndarray,
                 mat: np.ndarray, go: int = GAP_OPEN,
                 ge: int = GAP_EXTEND) -> Alignment:
    """Aligner::Align(query, window) -> Alignment (ssw_cpp.cpp:599-643 with
    flag 0x0f) via the native runtime (the Python/NumPy path below is the
    golden model it is tested against, align_window_py)."""
    from .. import native

    score, rb, re_, qb, qe, cigar = native.ssw_align(
        query_idx, ref_idx, mat, go, ge)
    if score == 0:
        return Alignment(sw_score=0)
    return Alignment(sw_score=score, ref_begin=rb, ref_end=re_,
                     query_begin=qb, query_end=qe, cigar=cigar)


def align_window_py(query_idx: np.ndarray, ref_idx: np.ndarray,
                    mat: np.ndarray, go: int = GAP_OPEN,
                    ge: int = GAP_EXTEND) -> Alignment:
    """Golden NumPy model of align_window (oracle-verified; kept as the
    differential-test target for the native path)."""
    al = Alignment()
    # forward pass: byte, escalate to word on saturation (sswNew.cpp:1471-1483)
    score, end_ref, end_read, sat = _sw_end_pass(
        query_idx, ref_idx, go, ge, mat, 16, True, None)
    if sat:
        score, end_ref, end_read, _ = _sw_end_pass(
            query_idx, ref_idx, go, ge, mat, 8, False, None)
    al.sw_score = score
    al.ref_end = end_ref
    al.query_end = end_read
    if score == 0:
        # no positive cell: the reverse rectangle is empty (refLen 0) and
        # the candidate is discarded by the caller's sw_score != 0 test
        return Alignment(sw_score=0)
    # reverse pass on the [0..end_read] x [0..end_ref] rectangle
    rev_query = query_idx[end_read::-1]
    rev_ref = ref_idx[end_ref::-1]
    lanes = 8 if sat else 16
    rscore, rend_col, rend_read, _ = _sw_end_pass(
        rev_query, rev_ref, go, ge, mat, lanes, False, score)
    al.ref_begin = end_ref - rend_col  # scan order k -> ref position
    al.query_begin = end_read - rend_read
    al.sw_score = min(rscore, score)  # fork quirk (sswNew.cpp:1518)
    # cigar via banded_sw over the sub-rectangle
    sub_ref = ref_idx[al.ref_begin:al.ref_end + 1]
    sub_read = query_idx[al.query_begin:al.query_end + 1]
    band_width = abs(len(sub_ref) - len(sub_read)) + 1
    cig = _banded_sw(sub_ref, sub_read, al.sw_score, go, ge, band_width, mat)
    if cig is None:
        return Alignment(sw_score=0)
    al.cigar = cig
    return al


def prealign_peaks(colmax: np.ndarray, threshold: int) -> list[tuple[int, int]]:
    """Run-clustering of above-threshold columns (preAlign,
    ssw_cpp.cpp:444-572).  Returns [(score, position)] in emission order.

    Columns with score > threshold form the candidate list; consecutive
    candidates with position gaps in 1..4 form runs; each run emits its
    first maximum; isolated candidates pass through; the final candidate is
    always emitted alone (checked before the run test).
    """
    cand = np.flatnonzero(colmax > threshold)
    scores = colmax[cand]
    n = len(cand)
    out: list[tuple[int, int]] = []
    num = 0
    output_num = -1
    while True:
        if num + 1 > n:
            break
        if num == n - 1:
            out.append((int(scores[n - 1]), int(cand[n - 1])))
            break
        if 0 < cand[num + 1] - cand[num] < 5:
            start = num
            tmp: list[int] = []
            while 0 < cand[num + 1] - cand[num] < 5:
                tmp.append(int(scores[num]))
                num += 1
                if num + 1 > n - 1:
                    break
            tmp.append(int(scores[num]))
            num += 1
            if tmp:
                max_index = int(np.argmax(tmp))  # first max (std::find)
                if num != output_num:
                    out.append((int(scores[start + max_index]),
                                int(cand[start + max_index])))
                output_num = start + max_index
        else:
            out.append((int(scores[num]), int(cand[num])))
            num += 1
    return out
