"""fastSIM on DNA records, from the bytes to the triplexes (plain PyTorch
and Python).

LongTarget (Fasim-LongTarget.cpp:379-598) over each record's segments and
its 48 scans; for each (segment, scan) pair the threshold and column-max
passes, preAlign's peaks (ssw_cpp.cpp:444-572), fastSIM's Iden sweep of
candidate windows (fastsim.h:158-289) with the striped aligner's forward
and reverse passes (sswNew.cpp:1446-1547) and banded_sw's traceback
(:1071-1259), convertMyTriplex (fastsim.h:291-414), the dedup chain and the
filters; then the final filter and the genome coordinates of main
(:129-163).  The DP passes run batched on `device`; the rest on the host.

`rnd` is the floating-point type of identity and stability: float32 as the
reference states, or a lower precision for the benchmark's control.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fasta, stdsort
from .dp import end_pass, scan_pass, score_rows
from .tables import (BYTE_SAT, GAP_EXTEND, GAP_OPEN, SSW_ENC, SSW_MAT,
                     STAB_ANTI, STAB_PARA, THRESH_ENC, THRESH_MAT, TOP_N,
                     scan_list, scan_strings)

f32 = np.float32
CELLS_A_CHUNK = 1 << 26


@dataclasses.dataclass
class Params:
    """The flags a run states (Fasim-LongTarget.cpp:284-303 defaults)."""

    rule: int = 0
    cut_length: int = 5000
    strand: int = 0
    overlap_length: int = 100
    nt_min: int = 20
    nt_max: int = 100000
    min_identity: float = 60.0
    min_stability: float = 1.0
    penalty_t: int = -1000
    penalty_c: int = 0
    c_distance: int = 15
    c_length: int = 50


@dataclasses.dataclass
class Hit:
    """One triplex as the output files show it (sim.h:20-45)."""

    stari: int
    endi: int
    starj: int
    endj: int
    strand: int
    reverse: int
    rule: int
    nt: int
    score: float
    identity: float
    tri_score: float
    stri_align: str
    strj_align: str
    chr: str = ""
    genomestart: int = 0
    genomeend: int = 0

    def key(self) -> tuple:
        return dataclasses.astuple(self)


@dataclasses.dataclass
class _Pair:
    record: int
    start: int
    scan: dict
    seq2: np.ndarray
    src: np.ndarray


def bfloat16(x) -> np.float32:
    """x rounded to bfloat16 (nearest, ties to even), as float32."""
    b = np.array([x], np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
         ) & np.uint32(0xFFFF0000)
    return b.view(np.float32)[0]


def prealign_peaks(colmax: np.ndarray, threshold: int) -> list:
    """preAlign's run clustering of the columns over the threshold:
    [(score, position)] in emission order."""
    cand = np.flatnonzero(colmax > threshold)
    scores = colmax[cand]
    n = len(cand)
    out = []
    num = 0
    output_num = -1
    while num + 1 <= n:
        if num == n - 1:
            out.append((int(scores[n - 1]), int(cand[n - 1])))
            break
        if 0 < cand[num + 1] - cand[num] < 5:
            start = num
            run = []
            while 0 < cand[num + 1] - cand[num] < 5:
                run.append(int(scores[num]))
                num += 1
                if num + 1 > n - 1:
                    break
            run.append(int(scores[num]))
            num += 1
            top = int(np.argmax(run))
            if num != output_num:
                out.append((int(scores[start + top]), int(cand[start + top])))
            output_num = start + top
        else:
            out.append((int(scores[num]), int(cand[num])))
            num += 1
    return out


def sweep_cutlengths(score: int, position: int) -> list[int]:
    """The window of each Iden step 0.6, 0.7, ... <= 1 (fastsim.h:209-211),
    in float32 as the reference computes it."""
    out = []
    iden = f32(0.6)
    while iden <= 1:
        c = int(f32(f32(score + 24) / f32(f32(9) * iden - f32(4))) + f32(1))
        out.append(position + 1 if position - c + 1 <= 0 else c)
        iden = f32(iden + f32(0.1))
    return out


def banded_sw(ref: list, read: list, score: int, bw: int, mat) -> list | None:
    """banded_sw: the cigar [(length, op)], or None on a traceback error.
    The direction codes sit in one flat array as the reference's do."""
    ref_len, read_len = len(ref), len(read)
    go, ge = GAP_OPEN, GAP_EXTEND
    max_sc = 0
    while True:
        width = bw * 2 + 3
        wd3 = (bw * 2 + 1) * 3
        h_b = [0] * (width + 1)
        e_b = [0] * (width + 1)
        h_c = [0] * (width + 1)
        direction = bytearray(read_len * wd3)
        u = 0
        for i in range(read_len):
            beg = max(0, i - bw)
            end = min(ref_len - 1, i + bw)
            edge = min(end + 1, width - 1)
            f = 0
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0
            x0 = beg
            x1 = max(i - 1 - bw, 0)
            row = i * wd3
            mcol = mat[read[i]]
            for j in range(beg, end + 1):
                u = j - x0 + 1
                e = j - x1 + 1
                dd = row + (j - x0) * 3
                if i == 0:
                    t1, t2 = -go, -ge
                else:
                    t1, t2 = h_b[e] - go, e_b[e] - ge
                if t1 > t2:
                    e_b[u] = t1
                    de = 3
                else:
                    e_b[u] = t2
                    de = 2
                direction[dd] = de
                t1 = h_c[u - 1] - go
                t2 = f - ge
                if t1 > t2:
                    f = t1
                    df = 5
                else:
                    f = t2
                    df = 4
                direction[dd + 1] = df
                e1 = e_b[u] if e_b[u] > 0 else 0
                f1 = f if f > 0 else 0
                t1 = e1 if e1 > f1 else f1
                t2 = h_b[e - 1] + mcol[ref[j]]
                h = t1 if t1 > t2 else t2
                h_c[u] = h
                if h > max_sc:
                    max_sc = h
                direction[dd + 2] = 1 if t1 <= t2 else (de if e1 > f1 else df)
            h_b[1:u + 1] = h_c[1:u + 1]
        if max_sc >= score:
            break
        bw *= 2
    i = read_len - 1
    j = ref_len - 1
    e = 0
    op = prev = "M"
    layer = 2
    ops = []
    while i > 0:
        at = i * wd3 + (j - max(i - bw, 0)) * 3 + layer
        code = direction[at] if 0 <= at < len(direction) else 0
        if code == 1:
            i, j, layer, op = i - 1, j - 1, 2, "M"
        elif code == 2:
            i, layer, op = i - 1, 0, "I"
        elif code == 3:
            i, layer, op = i - 1, 2, "I"
        elif code == 4:
            j, layer, op = j - 1, 1, "D"
        elif code == 5:
            j, layer, op = j - 1, 2, "D"
        else:
            return None
        if op == prev:
            e += 1
        else:
            ops.append((e, prev))
            prev = op
            e = 1
    if op == "M":
        ops.append((e + 1, op))
    else:
        ops.append((e, op))
        ops.append((1, "M"))
    ops.reverse()
    return ops


@dataclasses.dataclass
class _Align:
    score: int
    ref_begin: int
    ref_end: int
    query_begin: int
    query_end: int
    cigar: list


def _convert(al: _Align, rna: bytes, seq2: bytes, src: bytes, start: int,
             pair: _Pair, p: Params, rnd) -> Hit | None:
    """convertMyTriplex (fastsim.h:291-414)."""
    ref_a, read_a, src_a = [], [], []
    q = al.ref_begin
    r = al.query_begin
    for length, op in al.cigar:
        for _ in range(length):
            if op == "I":
                ref_a.append("-")
                src_a.append("-")
                read_a.append(chr(rna[r]))
                r += 1
            elif op == "D":
                ref_a.append(chr(seq2[q]))
                src_a.append(chr(src[q]))
                read_a.append("-")
                q += 1
            else:
                ref_a.append(chr(seq2[q]))
                src_a.append(chr(src[q]))
                read_a.append(chr(rna[r]))
                q += 1
                r += 1
    nt = len(ref_a)
    match = sum(1 for a, b in zip(ref_a, read_a) if a == b)
    identity = rnd(rnd(100 * match) / rnd(nt))
    tri = rnd(0.0)
    para = pair.scan["para"]
    strand = pair.scan["strand"]
    if p.nt_min <= nt <= p.nt_max:
        stab = STAB_PARA if para > 0 else STAB_ANTI
        zero = rnd(0.0)
        pen_t = rnd(p.penalty_t)
        pen_c = rnd(p.penalty_c)
        prechar = "\0"
        prescore = zero
        for i in range(nt):
            cur = "-" if ref_a[i] == "-" else src_a[i]
            value = rnd(stab.get((cur, read_a[i]), zero))
            if cur == prechar and cur == "T":
                tri = rnd(rnd(tri - prescore) + pen_t)
                value = pen_t
            if cur == prechar and cur == "C":
                tri = rnd(rnd(tri - prescore) + pen_c)
                value = pen_c
            prescore = value
            if ref_a[i] != "-":
                prechar = cur
            tri = rnd(tri + value)
        tri = rnd(tri / rnd(nt))
    n2 = len(seq2)
    if (para > 0 and strand == 1) or (para < 0 and strand == 0):
        ref_start, ref_end = n2 - al.ref_end - 1, n2 - al.ref_begin - 1
    else:
        ref_start, ref_end = al.ref_begin + 1, al.ref_end + 1
    if nt < p.nt_min:
        return None
    return Hit(stari=al.query_begin + 1, endi=al.query_end + 1,
               starj=ref_start + start, endj=ref_end + start, strand=strand,
               reverse=para, rule=pair.scan["rule"], nt=nt,
               score=float(f32(al.score)), identity=float(identity),
               tri_score=float(tri), stri_align="".join(read_a),
               strj_align="".join(src_a))


def _multiple(a, b):
    if a[0] == b[0]:
        if a[2] == b[2]:
            return a[4] > b[4]
        return a[2] > b[2]
    return a[2] > b[2]


def _multiple2(a, b):
    if a[1] == b[1]:
        if a[2] == b[2]:
            return a[4] > b[4]
        return a[2] < b[2]
    return a[2] < b[2]


def _single(a, b):
    return a[4] > b[4]


def _same(a, b):
    if a[:5] == b[:5]:
        return True
    return (b[0] >= a[0] and b[2] >= a[2] and b[1] <= a[1] and b[3] <= a[3]
            and b[4] < a[4])


def dedup(hits: list[Hit]) -> list[Hit]:
    """The dedup chain (fastsim.h:273-283): sort, unique, sort, unique,
    sort, on (stari, endi, starj, endj, score)."""
    v = [(h.stari, h.endi, h.starj, h.endj, h.score, k)
         for k, h in enumerate(hits)]
    stdsort.sort(v, _multiple)
    stdsort.unique(v, _same)
    stdsort.sort(v, _multiple2)
    stdsort.unique(v, _same)
    stdsort.sort(v, _single)
    return [hits[t[5]] for t in v]


def _chunks(n: int, rows: int):
    step = max(1, CELLS_A_CHUNK // max(rows, 1))
    for a in range(0, n, step):
        yield slice(a, min(n, a + step))


def _forward(q: np.ndarray, windows: list[np.ndarray], device,
             lanes: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The forward pass of the query against each window, lanes rows a
    stripe."""
    m = len(q)
    rows = m + (-m) % lanes
    prof = torch.as_tensor(score_rows(q, SSW_MAT, rows), device=device)
    out = [np.zeros(len(windows), np.int64) for _ in range(3)]
    for sl in _chunks(len(windows), rows):
        ws = windows[sl]
        L = max(len(w) for w in ws)
        codes = np.zeros((len(ws), L), np.int64)
        for k, w in enumerate(ws):
            codes[k, :len(w)] = w
        res = end_pass(prof[None].expand(len(ws), -1, -1),
                       np.full(len(ws), rows), np.full(len(ws), m), codes,
                       np.array([len(w) for w in ws]), None, device)
        for o, r in zip(out, res):
            o[sl] = r
    return out[0], out[1], out[2]


def _reverse(q: np.ndarray, windows: list[np.ndarray], end_rows: np.ndarray,
             lanes: np.ndarray, terminate: np.ndarray, device):
    """The reverse pass: the reversed query prefix q[end_row::-1] and its
    phantom rows against the window read backwards, stopping at the
    first column whose maximum equals terminate."""
    prof = np.vstack([SSW_MAT[q], np.zeros((1, SSW_MAT.shape[1]), np.int64)])
    prof_t = torch.as_tensor(prof.astype(np.int32), device=device)
    real = end_rows + 1
    rows = real + (-real) % lanes
    out = [np.zeros(len(windows), np.int64) for _ in range(3)]
    R_all = int(rows.max()) if len(rows) else 0
    for sl in _chunks(len(windows), R_all):
        ws = windows[sl]
        R = int(rows[sl].max())
        i = np.arange(R)[None, :]
        idx = np.where(i < real[sl, None], end_rows[sl, None] - i, len(q))
        score = prof_t[torch.as_tensor(idx, device=device)]
        L = max(len(w) for w in ws)
        codes = np.zeros((len(ws), L), np.int64)
        for k, w in enumerate(ws):
            codes[k, :len(w)] = w[::-1]
        res = end_pass(score, rows[sl], real[sl], codes,
                       np.array([len(w) for w in ws]), terminate[sl], device)
        for o, r in zip(out, res):
            o[sl] = r
    return out[0], out[1], out[2]


def _sequential(q, r_codes, score, position, device) -> _Align | None:
    """The Iden sweep one window at a time, each through the whole
    aligner (forward, reverse, traceback): the reference's own order,
    taken only when the batched sweep's chosen window fails its
    traceback."""
    best = None
    last = None
    for cl in sweep_cutlengths(score, position):
        w = r_codes[position - cl + 1: position + 1]
        al = _align_one(q, w, device)
        last = (al, cl)
        if al is not None and al.score >= score:
            return _shift(al, position, cl)
        if (al is not None and (best is None or al.score > best[0].score)
                and al.ref_end == cl - 1):
            best = (al, cl)
    al, cl = best if best is not None else last
    return _shift(al, position, cl) if al is not None else None


def _shift(al: _Align, position: int, cl: int) -> _Align:
    off = position - cl + 1
    return dataclasses.replace(al, ref_begin=al.ref_begin + off,
                               ref_end=al.ref_end + off)


def _align_one(q, w, device) -> _Align | None:
    best, ecol, erow = _forward(q, [w], device, 16)
    if best[0] >= BYTE_SAT and (-len(q)) % 8 != (-len(q)) % 16:
        best, ecol, erow = _forward(q, [w], device, 8)
    if best[0] == 0:
        return None
    lanes = np.array([8 if best[0] >= BYTE_SAT else 16])
    rb, rc, rr = _reverse(q, [w[:ecol[0] + 1]], erow, lanes, best, device)
    return _finish(q, w, int(min(rb[0], best[0])), int(ecol[0] - rc[0]),
                   int(ecol[0]), int(erow[0] - rr[0]), int(erow[0]))


def _finish(q, w, score, rb, re_, qb, qe) -> _Align | None:
    sub_ref = [int(c) for c in w[rb:re_ + 1]]
    sub_read = [int(c) for c in q[qb:qe + 1]]
    bw = abs(len(sub_ref) - len(sub_read)) + 1
    cig = banded_sw(sub_ref, sub_read, score, bw, _MAT)
    if cig is None:
        return None
    return _Align(score, rb, re_, qb, qe, cig)


_MAT = [[int(v) for v in row] for row in SSW_MAT]


def record_hits(p: Params, rna: np.ndarray, records: list[fasta.Record],
                device, rnd=f32) -> list[list[Hit]]:
    """Each record's triplexes, as main passes them to printResult."""
    q = SSW_ENC[rna]
    scans = scan_list(p.rule, p.strand)
    pairs: list[_Pair] = []
    for ri, rec in enumerate(records):
        segs, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                          p.overlap_length)
        for seg, start in zip(segs, starts):
            if fasta.same_seq(seg):
                continue
            for scan in scans:
                pairs.append(_Pair(ri, start, scan, *scan_strings(seg, scan)))
    out: list[list[Hit]] = [[] for _ in records]
    if not pairs:
        return out
    lens = np.array([len(x.seq2) for x in pairs])
    N = int(lens.max())
    thr_codes = np.zeros((len(pairs), N), np.int64)
    ssw_codes = np.zeros((len(pairs), N), np.int64)
    for k, x in enumerate(pairs):
        thr_codes[k, :lens[k]] = THRESH_ENC[x.seq2]
        ssw_codes[k, :lens[k]] = SSW_ENC[x.seq2]
    thresh = np.concatenate([
        scan_pass(THRESH_ENC[rna], THRESH_MAT, thr_codes[sl], lens[sl],
                  False, device)[0]
        for sl in _chunks(len(pairs), len(rna))])
    colmax = np.concatenate([
        scan_pass(q, SSW_MAT, ssw_codes[sl], lens[sl], True, device)[1]
        for sl in _chunks(len(pairs), len(rna))])

    # every peak of every pair, and its sweep's windows
    peaks = []  # (pair, score, position, cutlengths)
    for k, x in enumerate(pairs):
        min_score = int(int(thresh[k]) * 0.8)
        for score, pos in prealign_peaks(colmax[k, :lens[k]], min_score):
            peaks.append((k, score, pos, sweep_cutlengths(score, pos)))
    chosen = _sweep(q, ssw_codes, peaks, device)

    cands: list[list[Hit]] = [[] for _ in pairs]
    rna_b = rna.tobytes()
    for (k, score, pos, _), al in zip(peaks, chosen):
        if al is None:
            continue
        x = pairs[k]
        hit = _convert(al, rna_b, x.seq2.tobytes(), x.src.tobytes(),
                       x.start, x, p, rnd)
        if hit is not None:
            cands[k].append(hit)
    for k, x in enumerate(pairs):
        for h in dedup(cands[k])[:TOP_N]:
            if (h.identity >= rnd(p.min_identity)
                    and h.tri_score >= rnd(p.min_stability)
                    and h.nt >= p.nt_min):
                out[x.record].append(h)
    for ri, rec in enumerate(records):
        kept = [h for h in out[ri]
                if h.score >= 0.0 and h.identity >= rnd(p.min_identity)
                and h.tri_score >= rnd(p.min_stability)
                and h.nt >= p.c_length]
        for h in kept:
            h.chr = rec.chro_tag
            h.genomestart = h.starj + rec.start_genome - 1
            h.genomeend = h.endj + rec.start_genome - 1
        out[ri] = kept
    return out


def _sweep(q: np.ndarray, ssw_codes: np.ndarray, peaks: list, device
           ) -> list[_Align | None]:
    """fastSIM's Iden sweep (fastsim.h:202-250) for every peak: the
    chosen window's alignment, shifted to the pair's coordinates, or None
    when its score is 0.  A window's forward pass gives its score (the
    reverse pass's maximum is never below it, and the aligner takes the
    smaller), so all windows' forward passes run first, and the reverse
    pass and traceback only on the chosen ones."""
    nr = [len(c) for _, _, _, c in peaks]
    if not peaks:
        return []
    # round 0 for every peak, the later distinct windows after
    jobs = [(i, 0) for i in range(len(peaks))]
    res = _run_windows(q, ssw_codes, peaks, jobs, device)
    rest = [i for i, (_, score, _, _) in enumerate(peaks)
            if res[(i, 0)][0] < score]
    later = [(i, r) for i in rest for r in range(1, nr[i])
             if peaks[i][3][r] != peaks[i][3][r - 1]]
    res.update(_run_windows(q, ssw_codes, peaks, later, device))
    for i in rest:
        for r in range(1, nr[i]):
            if (i, r) not in res:
                res[(i, r)] = res[(i, r - 1)]
    picks = []
    for i, (k, score, pos, cls) in enumerate(peaks):
        pick = None
        fallback = None
        fb_score = 0
        for r, cl in enumerate(cls):
            b, ecol, _ = res[(i, r)]
            if b >= score:
                pick = r
                break
            if b > fb_score and b > 0 and ecol == cl - 1:
                fb_score = b
                fallback = r
        if pick is None:
            pick = fallback if fallback is not None else len(cls) - 1
        picks.append(pick)
    # reverse pass and traceback of the chosen windows
    win = [i for i, r in enumerate(picks) if res[(i, r)][0] > 0]
    out: list[_Align | None] = [None] * len(peaks)
    if not win:
        return out
    windows, erows, lanes, term = [], [], [], []
    for i in win:
        k, score, pos, cls = peaks[i]
        cl = cls[picks[i]]
        b, ecol, erow = res[(i, picks[i])]
        windows.append(ssw_codes[k, pos - cl + 1: pos - cl + 1 + ecol + 1])
        erows.append(erow)
        lanes.append(8 if b >= BYTE_SAT else 16)
        term.append(b)
    rb, rc, rr = _reverse(q, windows, np.array(erows), np.array(lanes),
                          np.array(term), device)
    for n, i in enumerate(win):
        k, score, pos, cls = peaks[i]
        cl = cls[picks[i]]
        b, ecol, erow = res[(i, picks[i])]
        w = ssw_codes[k, pos - cl + 1: pos + 1]
        al = _finish(q, w, int(min(rb[n], b)), int(ecol - rc[n]), int(ecol),
                     int(erow - (rr[n])), int(erow))
        if al is None:
            al = _sequential(q, ssw_codes[k], score, pos, device)
            out[i] = al
        else:
            out[i] = _shift(al, pos, cl)
    return out


def _run_windows(q, ssw_codes, peaks, jobs, device) -> dict:
    """Forward passes of the (peak, round) windows in `jobs`: (best, end
    column, end row) each, with the word aligner's phantom rows where the
    byte aligner saturates."""
    if not jobs:
        return {}
    windows = []
    for i, r in jobs:
        k, _, pos, cls = peaks[i]
        cl = cls[r]
        windows.append(ssw_codes[k, pos - cl + 1: pos + 1])
    best, ecol, erow = _forward(q, windows, device, 16)
    m = len(q)
    if (-m) % 8 != (-m) % 16:
        sat = np.flatnonzero(best >= BYTE_SAT)
        if len(sat):
            b8, c8, r8 = _forward(q, [windows[s] for s in sat], device, 8)
            best[sat], ecol[sat], erow[sat] = b8, c8, r8
    return {job: (int(best[n]), int(ecol[n]), int(erow[n]))
            for n, job in enumerate(jobs)}
