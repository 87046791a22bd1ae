"""Device-batched fastSIM candidate stage (copy of
fasim_tpu/scan/candidates.py; it calls only the engine's
`window_pass_specs` / `window_pass`).

The candidate stage (fastsim.h:158-289) re-aligns the full query against a
short window around every above-threshold colmax peak — at genome scale
that is hundreds of thousands of (query x ~200 bp) DP passes, the host
stage's largest cost if run there.  This module moves the two hot passes of each candidate
alignment (the forward end-finding and reverse begin-finding striped
passes, sswNew.cpp:1446-1547) onto the device as batched window passes
(SURVEY.md §2.a row 3), leaving on host only:

  * peak extraction (native lt_segment_peaks — trivial),
  * the Iden-sweep bookkeeping, vectorized in NumPy,
  * banded_sw traceback + convertMyTriplex + dedup (native, tiny).

The device interface is transfer-minimal: per window row ~26 B of specs go in (the codes are gathered on
device from the batch's resident segment bytes + scan LUTs) and 12 B of
(best, end_col, end_row) come out, reduced on device.

Key exactness facts this relies on (tested in tests/test_window_pass.py):

  * Forward-pass outputs are independent of the byte/word phantom-row
    layout, so exact int32 needs no byte->word escalation replay.
  * The reverse pass's max is >= the forward max (the reversed optimal
    path is a valid alignment of the reversed rectangle), so
    sw_score = min(reverse, forward) = forward — the Iden sweep's
    accept/fallback decisions depend on the forward pass only, and the
    reverse pass runs once per *winning* window, not per sweep round.
  * The reverse pass's terminate-equality break depends on the phantom
    rows' diagonal carry, so the device pass takes the exact per-row
    phantom bound (m + (-Mr) % lanes, lanes 8 after forward saturation).

banded_sw can in principle report a traceback error (reference prints
"Trace back error" and our emulation returns sw_score 0, which would have
altered the sweep).  This has never been observed on any golden or random
differential input; if it ever happens the affected (segment, transform)
pair is transparently re-run through the exact sequential host path.
"""

from __future__ import annotations

import numpy as np

from .. import native, rules
from ..config import BYTE_SAT, GAP_EXTEND, GAP_OPEN, Params
from ..profiling import STAGES
from .pipeline import Triplex

f32 = np.float32

WPAD = 256  # >= max cutlength: peaks score <= 250 -> <= (250+24)/1.4+1 = 196


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def sweep_cutlengths(scores: np.ndarray, positions: np.ndarray
                     ) -> np.ndarray:
    """All Iden-sweep window sizes per peak, exact f32 arithmetic
    (fastsim.h:209-211).  Returns int64[npeaks, nrounds]."""
    idens = []
    iden = f32(0.6)
    while iden <= 1:
        idens.append(iden)
        iden = f32(iden + f32(0.1))
    out = np.empty((len(scores), len(idens)), np.int64)
    s24 = f32(scores.astype(np.int64) + 24)
    for r, iden in enumerate(idens):
        c = (s24 / f32(f32(9) * iden - f32(4)) + f32(1)).astype(np.int64)
        clamp = positions - c + 1 <= 0
        out[:, r] = np.where(clamp, positions + 1, c)
    return out


def align_via_window_pass(eng, q_idx: np.ndarray, ref_u8: np.ndarray,
                          mat: np.ndarray, go: int = GAP_OPEN,
                          ge: int = GAP_EXTEND):
    """Single-window align chain on the device window pass (test harness;
    the batch path below is the production equivalent).  Must equal
    kernels.align.align_window_py bit-for-bit."""
    from ..kernels import align as kalign

    m = len(q_idx)
    w = len(ref_u8)
    wpad = _round_up(max(w, 8), 8)
    codes = np.full((1, wpad), 4, np.uint8)
    codes[0, :w] = ref_u8
    out = np.asarray(eng.window_pass(
        codes, np.zeros(1, np.int32), np.full(1, -1, np.int32),
        np.full(1, w, np.int32), np.full(1, _round_up(m, 16), np.int32),
        rev=False))
    best, ecol, erow = (int(out[0, 0]), int(out[0, 1]), int(out[0, 2]))
    if best == 0:
        return kalign.Alignment(sw_score=0)
    lanes = 8 if best >= BYTE_SAT else 16
    rlen = ecol + 1
    rcodes = np.full((1, wpad), 4, np.uint8)
    rcodes[0, :rlen] = ref_u8[ecol::-1]
    off = m - 1 - erow
    out_r = np.asarray(eng.window_pass(
        rcodes, np.full(1, off, np.int32), np.full(1, best, np.int32),
        np.full(1, rlen, np.int32),
        np.full(1, m + (-(erow + 1)) % lanes, np.int32), rev=True))
    rb, rc, rr = (int(out_r[0, 0]), int(out_r[0, 1]), int(out_r[0, 2]))
    al = kalign.Alignment(
        sw_score=min(rb, best), ref_begin=ecol - rc, ref_end=ecol,
        query_begin=erow - (rr - off), query_end=erow)
    sub_ref = ref_u8[al.ref_begin:al.ref_end + 1].astype(np.int64)
    sub_read = q_idx[al.query_begin:al.query_end + 1]
    bw = abs(len(sub_ref) - len(sub_read)) + 1
    cig = kalign._banded_sw(sub_ref, sub_read, al.sw_score, go, ge, bw, mat)
    if cig is None:
        return kalign.Alignment(sw_score=0)
    al.cigar = cig
    return al


class SegmentSources:
    """Per-segment source-string variants (finalize/convert inputs)."""

    def __init__(self, seg: np.ndarray):
        self.seg = seg
        srcs = [seg, rules.reverse(rules.complement(seg)),
                rules.complement(seg), rules.reverse(seg)]
        self.src_bytes = [np.ascontiguousarray(s).tobytes() for s in srcs]
        self.src_lens = np.array([len(s) for s in self.src_bytes], np.int64)


def _scan_strings(meta, seg: np.ndarray, k: int):
    """Transformed chars + SSW codes of one (segment, scan) pair."""
    sel = seg[::-1] if meta.xform_rev[k] else seg
    chars = meta.luts[k][sel]
    return chars, np.ascontiguousarray(meta.ssw_enc_u8[chars], np.int32)


def candidate_stage_batch(p: Params, rna: np.ndarray, q_idx: np.ndarray,
                          rna_b: bytes, meta, batch, segs: np.ndarray,
                          lengths: np.ndarray, gm: np.ndarray, cm_get,
                          packed, eng, pool, cm_fallback=None) -> list:
    """Run the candidate stage for one device batch.  batch is the list
    of _Work items; segs/lengths the batch's padded device-input arrays;
    gm int32[B, K]; cm_get(i) lazily yields segment i's full uint8[K, N]
    colmax rows (a host array slice or a device fetch); packed is the
    device-compacted (pos, val, cnt) candidate triple or None.  Returns a
    list of (work item, future -> [Triplex]) in batch order.

    Device window passes run on the caller thread (the batched scan runs one
    thread per in-flight batch to overlap link latency); the final
    banded/convert/dedup per segment runs on the thread pool.
    """
    K = len(meta.scans)
    stride = segs.shape[1]

    # 1. peaks per segment (native; scan-major order inside each segment)
    with STAGES.timer("cand_peaks"):
        over_rows: dict = {}
        if packed is not None:
            kp = packed[0].shape[2]
            over = np.argwhere(packed[2] > kp)  # (n, 2): seg, scan
            if len(over):
                # one batched device gather for every overflowing pair
                # (per-pair fetches would pay a link round trip each);
                # indices pad to a fixed bucket so the gather compiles
                # once, not per overflow count
                nov = len(over)
                bucket = 16
                while bucket < nov:
                    bucket *= 2
                oi = np.zeros(bucket, np.int64)
                ok = np.zeros(bucket, np.int64)
                oi[:nov] = over[:, 0]
                ok[:nov] = over[:, 1]
                fetched = cm_get((oi, ok))[:nov]
                for (i, k), row in zip(over, fetched):
                    over_rows[(int(i), int(k))] = row
        peak_parts = []
        for i, w in enumerate(batch):
            n = len(w.segment)
            if packed is not None:
                cnt = packed[2][i].copy()
                okeys = [k for (si, k) in over_rows if si == i]
                cnt[okeys] = 0  # overflow scans handled from full rows
                pk = native.segment_peaks_packed(
                    packed[0][i], packed[1][i], cnt)
                if okeys:
                    parts = [pk]
                    for k in okeys:
                        row = over_rows[(i, k)][None, :]
                        pk1 = native.segment_peaks(row, stride,
                                                   gm[i, k:k + 1], n)
                        if len(pk1):
                            pk1[:, 0] = k
                            parts.append(pk1)
                    pk = np.concatenate(parts)
                    pk = pk[np.argsort(pk[:, 0], kind="stable")]
            else:
                pk = native.segment_peaks(cm_get(i), stride, gm[i], n)
            if len(pk):
                peak_parts.append(np.column_stack(
                    [np.full(len(pk), i, np.int64), pk]))
        if not peak_parts:
            from concurrent.futures import Future

            outs = []
            for w in batch:
                fut = Future()
                fut.set_result([])
                outs.append((w, fut))
            return outs
        peaks = np.concatenate(peak_parts)  # (P, 4): seg_i, scan, score, pos
    STAGES.count("peaks", len(peaks))
    seg_i = peaks[:, 0]
    scan_i = peaks[:, 1]
    score = peaks[:, 2]
    pos = peaks[:, 3]
    P = len(peaks)

    m = len(rna)
    m16 = _round_up(m, 16)
    cutlens = sweep_cutlengths(score, pos)  # (P, NR)
    nr = cutlens.shape[1]

    def fwd_specs(idx, cl):
        return {
            "seg_idx": seg_i[idx].astype(np.int32),
            "scan_idx": scan_i[idx].astype(np.int32),
            "base": (pos[idx] - cl + 1).astype(np.int32),
            "dirn": np.ones(len(idx), np.int32),
            "rlens": cl.astype(np.int32),
            "offs": np.zeros(len(idx), np.int32),
            "terms": np.full(len(idx), -1, np.int32),
            "mreals": np.full(len(idx), m16, np.int32),
        }

    # 2. Iden sweep in two speculative phases: round 0 for every peak
    # (most peaks accept there — the Iden=0.6 window is the widest), then
    # every remaining distinct (peak, cutlength) window of the
    # non-accepting peaks in ONE second dispatch.  Two link round trips
    # per batch regardless of sweep depth — the lazy per-round dispatch
    # paid up to nr — while skipping ~60% of the device work a fully
    # speculative all-rounds dispatch would waste on accepted peaks.
    # The decision logic below reads only rounds up to acceptance, so
    # results are bit-identical to the sequential sweep.
    r_best = np.zeros((P, nr), np.int64)
    r_ecol = np.full((P, nr), -1, np.int64)
    r_erow = np.zeros((P, nr), np.int64)
    STAGES.count("window_rows_fwd0", P)
    with STAGES.timer("cand_fwd_dev"):
        out0 = eng.window_pass_specs(
            segs, lengths, fwd_specs(np.arange(P), cutlens[:, 0]),
            rev=False)
    r_best[:, 0] = out0[:, 0]
    r_ecol[:, 0] = out0[:, 1]
    r_erow[:, 0] = out0[:, 2]
    rest = np.flatnonzero(r_best[:, 0] < score)  # not accepted at round 0
    if len(rest) and nr > 1:
        # cutlengths are non-increasing over rounds, so duplicates are
        # consecutive; dispatch only the distinct windows
        uniq = cutlens[rest, 1:] != cutlens[rest, :-1]  # (len(rest), nr-1)
        pk_r, rd_r = np.nonzero(uniq)
        pk = rest[pk_r]
        rd = rd_r + 1
        STAGES.count("window_rows_fwd1", len(pk))
        with STAGES.timer("cand_fwd_dev"):
            out = eng.window_pass_specs(
                segs, lengths, fwd_specs(pk, cutlens[pk, rd]), rev=False)
        r_best[pk, rd] = out[:, 0]
        r_ecol[pk, rd] = out[:, 1]
        r_erow[pk, rd] = out[:, 2]
        for r in range(1, nr):
            dup = rest[~uniq[:, r - 1]]  # identical window, identical DP
            r_best[dup, r] = r_best[dup, r - 1]
            r_ecol[dup, r] = r_ecol[dup, r - 1]
            r_erow[dup, r] = r_erow[dup, r - 1]
    # sweep decisions (fastsim.h:202-241): sw_score == forward best
    resolved = np.zeros(P, bool)
    fb_score = np.zeros(P, np.int64)
    fb_round = np.full(P, -1, np.int64)
    for r in range(nr):
        live = np.flatnonzero(~resolved)
        if not len(live):
            break
        cl = cutlens[live, r]
        b = r_best[live, r]
        accept = b >= score[live]
        resolved[live[accept]] = True
        fb = ~accept & (b > fb_score[live]) & (r_ecol[live, r] == cl - 1)
        fb_idx = live[fb]
        fb_score[fb_idx] = r_best[fb_idx, r]
        fb_round[fb_idx] = r
    chosen = np.where(resolved,
                      np.argmax(r_best >= score[:, None], axis=1), nr - 1)
    # unresolved peaks fall back to the best full-window round (myflag 2)
    # or, with no fallback, the last round's alignment (myflag 0)
    unres = ~resolved
    chosen[unres & (fb_round >= 0)] = fb_round[unres & (fb_round >= 0)]
    c_best = r_best[np.arange(P), chosen]
    c_ecol = r_ecol[np.arange(P), chosen]
    c_erow = r_erow[np.arange(P), chosen]
    c_cut = cutlens[np.arange(P), chosen]
    winner = c_best != 0  # fastsim.h:250 sw_score != 0 gate

    # 3. reverse pass for winners only.  Adjacent peaks that converged to
    # the same winning window yield bit-identical spec rows (the pass is
    # a pure function of the row), so dispatch each distinct row once and
    # scatter the result back — on MEG3-full this cuts the rev rows ~2x.
    wi = np.flatnonzero(winner)
    STAGES.count("winners", len(wi))
    meta5 = np.zeros((P, 5), np.int32)
    if len(wi):
        lanes = np.where(c_best[wi] >= BYTE_SAT, 8, 16)
        smat = np.column_stack([
            seg_i[wi], scan_i[wi],
            # reverse read of the chosen window: lane l = window[ecol - l]
            pos[wi] - c_cut[wi] + 1 + c_ecol[wi],
            np.full(len(wi), -1), c_ecol[wi] + 1,
            m - 1 - c_erow[wi], c_best[wi],
            m + (-(c_erow[wi] + 1)) % lanes]).astype(np.int32)
        uniq, inv = np.unique(smat, axis=0, return_inverse=True)
        spec = dict(zip(
            ("seg_idx", "scan_idx", "base", "dirn", "rlens", "offs",
             "terms", "mreals"),
            np.ascontiguousarray(uniq.T)))
        STAGES.count("window_rows_rev", len(uniq))
        with STAGES.timer("cand_rev_dev"):
            out_r = eng.window_pass_specs(segs, lengths, spec, rev=True)[inv]
        sw_final = np.minimum(out_r[:, 0], c_best[wi])  # sswNew.cpp:1518
        ref_begin = c_ecol[wi] - out_r[:, 1]
        query_begin = c_erow[wi] - (out_r[:, 2] - smat[:, 5])
        off0 = pos[wi] - c_cut[wi] + 1  # window -> segment coords
        meta5[wi, 0] = sw_final
        meta5[wi, 1] = (ref_begin + off0).astype(np.int32)
        meta5[wi, 2] = (c_ecol[wi] + off0).astype(np.int32)
        meta5[wi, 3] = query_begin.astype(np.int32)
        meta5[wi, 4] = c_erow[wi].astype(np.int32)

    # 4. finalize per segment on the pool (banded + convert + dedup).
    # The fallback row accessor deliberately does NOT close over the
    # batch's device colmax (cm_fallback recomputes it on the
    # never-observed banded-error path) so the device arrays free as
    # soon as this function returns, not when the batch is consumed.
    cm_fb = cm_fallback if cm_fallback is not None else cm_get
    outs = []
    for i, w in enumerate(batch):
        sel = np.flatnonzero((seg_i == i) & winner)
        outs.append((w, pool.submit(
            STAGES.spanned("cand_finalize_busy", _finalize_segment,
                           segment=i), p, rna, q_idx, rna_b, meta, w,
            scan_i[sel], meta5[sel], gm[i],
            (lambda i=i: cm_fb(i)))))
    return outs


def _finalize_segment(p: Params, rna: np.ndarray, q_idx: np.ndarray,
                      rna_b: bytes, meta, w, scan_sel: np.ndarray,
                      meta5: np.ndarray, gm_row: np.ndarray,
                      cm_row_get) -> list[Triplex]:
    """Banded traceback + convert + dedup/filter for one segment's winning
    candidates, per scan in scan order (the reference's iteration order).
    Runs on the pool, inside the span `cand_finalize_busy`."""
    found: list[Triplex] = []
    if not len(scan_sel):
        return found
    src = SegmentSources(w.segment)
    n = len(w.segment)
    scans = meta.scans
    for k in np.unique(scan_sel):
        rows = np.flatnonzero(scan_sel == k)
        scan = scans[int(k)]
        chars, r_idx = _scan_strings(meta, w.segment, int(k))
        s2_b = chars.tobytes()
        src_b = src.src_bytes[meta.src_sel[k]]
        if src.src_lens[meta.src_sel[k]] != n:
            raise ValueError(
                "source-string length mismatch (complement drops "
                "non-ACGTN characters): reference behavior is "
                "undefined on this input")
        res = native.finalize_pair(
            q_idx, r_idx, rna_b, s2_b, src_b,
            np.ascontiguousarray(meta5[rows], np.int32), meta.mat,
            GAP_OPEN, GAP_EXTEND, w.start, scan["strand"],
            scan["para"], p.nt_min, p.nt_max, p.penalty_t, p.penalty_c,
            f32(p.min_identity), f32(p.min_stability))
        if res is None:
            # banded traceback error (never observed): exact rerun of
            # the whole pair through the sequential host path
            res = _pair_fallback(p, rna, q_idx, rna_b, meta, w, src,
                                 chars, r_idx, int(k), gm_row,
                                 cm_row_get())
        for r in res:
            found.append(Triplex(
                stari=r[0], endi=r[1], starj=r[2], endj=r[3],
                strand=scan["strand"], reverse=scan["para"],
                rule=scan["rule"], nt=r[4], score=f32(r[5]),
                identity=f32(r[6]), tri_score=f32(r[7]),
                stri_align=r[8], strj_align=r[9]))
    return found


def _pair_fallback(p: Params, rna: np.ndarray, q_idx: np.ndarray,
                   rna_b: bytes, meta, w, src: SegmentSources,
                   chars: np.ndarray, r_idx: np.ndarray, k: int,
                   gm_row: np.ndarray, cm_seg: np.ndarray) -> list[tuple]:
    """Exact sequential host path for one (segment, transform) pair."""
    row = cm_seg[k]
    sat = np.flatnonzero(row >= BYTE_SAT)
    stop = int(sat[0]) if len(sat) else len(w.segment)
    colmax = np.zeros(len(w.segment), np.int32)
    colmax[:stop] = row[:stop]
    min_score = int(int(gm_row[k]) * 0.8)
    src_b = src.src_bytes[meta.src_sel[k]]
    rows = native.fastsim_pair(
        q_idx, r_idx, rna_b, chars.tobytes(), src_b, colmax, meta.mat,
        GAP_OPEN, GAP_EXTEND, w.start, min_score, meta.strands[k],
        meta.paras[k], p.nt_min, p.nt_max, p.penalty_t, p.penalty_c,
        f32(p.min_identity), f32(p.min_stability))
    return [(r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9])
            for r in rows]
