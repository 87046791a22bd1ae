// Native fastSIM candidate stage: everything downstream of the device
// colmax pass for one (segment, transform) pair, in one call.
//
// Mirrors (bit-for-bit) the oracle-verified Python models in
// scan/pipeline.py and kernels/align.py:
//   * prealign peak clustering (ssw_cpp.cpp:444-572);
//   * the Iden window sweep with its float32 cutlength arithmetic and the
//     best-alignment fallback (fastsim.h:202-272);
//   * candidate realignment via the shared align core (sswNew.cpp
//     ssw_align emulation);
//   * convertMyTriplex: cigar walk to three aligned strings, identity,
//     float32 stability with TT/CC run penalties, coordinate flip
//     (fastsim.h:291-414);
//   * the dedup chain + top-50 cap + identity/stability/length filter
//     (fastsim.h:273-288), reusing lt_fastsim_dedup from lt_sort.cpp so
//     tie-handling is libstdc++'s.
//
// One call per pair lets the Python driver run pairs on a thread pool
// (the GIL is released for the call's duration).
//
// Built into _fasim_native.so together with the other native sources.

#include <array>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include "align_core.h"

extern "C" int32_t lt_fastsim_dedup(const int32_t* stari, const int32_t* endi,
                                    const int32_t* starj, const int32_t* endj,
                                    const float* score, int32_t n,
                                    int32_t* out_idx);

namespace {

constexpr long TOP_N = 50;  // fastsim.h:8  #define N 50

// sim.h:72-97 / rules stability tables (shared with the SIM engine).
float stab(char c1, char c2, long para) {
    if (para > 0) {
        if (c1 == 'A' && c2 == 'T') return 3.7f;
        if (c1 == 'T' && c2 == 'G') return 2.8f;
        if (c1 == 'G' && c2 == 'G') return 2.2f;
        if (c1 == 'G' && c2 == 'T') return 2.4f;
        if (c1 == 'G' && c2 == 'C') return 4.5f;
        if (c1 == 'C' && c2 == 'T') return 2.6f;
        if (c1 == 'C' && c2 == 'C') return 2.4f;
    } else {
        if (c1 == 'A' && c2 == 'A') return 3.0f;
        if (c1 == 'A' && c2 == 'T') return 3.5f;
        if (c1 == 'A' && c2 == 'C') return 1.0f;
        if (c1 == 'T' && c2 == 'G') return 1.0f;
        if (c1 == 'G' && c2 == 'A') return 1.0f;
        if (c1 == 'G' && c2 == 'G') return 3.0f;
        if (c1 == 'G' && c2 == 'C') return 3.0f;
        if (c1 == 'C' && c2 == 'T') return 2.0f;
        if (c1 == 'C' && c2 == 'C') return 1.0f;
    }
    return 0.0f;
}

struct Cand {
    int32_t stari, endi, starj, endj, nt;
    float score, identity, tri;
    std::string ra, rsrc;
};

// Peak clustering over an already-extracted candidate list (positions
// ascending, values = byte-broken colmax) — the core of preAlign
// (ssw_cpp.cpp:444-572; mirrors kernels/align.py prealign_peaks).
template <typename PosT, typename ValT>
void peaks_from_cands(const PosT* cand, const ValT* cval, long n,
                      std::vector<std::pair<int32_t, long>>& out) {
    long num = 0;
    long output_num = -1;
    for (;;) {
        if (num + 1 > n) break;
        if (num == n - 1) {
            out.emplace_back((int32_t)cval[n - 1], (long)cand[n - 1]);
            break;
        }
        if (cand[num + 1] - cand[num] > 0 && cand[num + 1] - cand[num] < 5) {
            const long start = num;
            std::vector<int32_t> tmp;
            while (cand[num + 1] - cand[num] > 0 &&
                   cand[num + 1] - cand[num] < 5) {
                tmp.push_back((int32_t)cval[num]);
                num++;
                if (num + 1 > n - 1) break;
            }
            tmp.push_back((int32_t)cval[num]);
            num++;
            long max_index = 0;  // first maximum (std::find semantics)
            for (long t = 1; t < (long)tmp.size(); t++)
                if (tmp[t] > tmp[max_index]) max_index = t;
            if (num != output_num)
                out.emplace_back((int32_t)cval[start + max_index],
                                 (long)cand[start + max_index]);
            output_num = start + max_index;
        } else {
            out.emplace_back((int32_t)cval[num], (long)cand[num]);
            num++;
        }
    }
}

// Peak clustering of above-threshold columns (full colmax row variant).
void peaks_of(const int32_t* colmax, long N, long threshold,
              std::vector<std::pair<int32_t, long>>& out) {
    std::vector<int32_t> cand, cval;
    for (long j = 0; j < N; j++)
        if (colmax[j] > threshold) {
            cand.push_back((int32_t)j);
            cval.push_back(colmax[j]);
        }
    peaks_from_cands(cand.data(), cval.data(), (long)cand.size(), out);
}

// convertMyTriplex (fastsim.h:291-414) on one alignment.
void convert(const int32_t* meta, const int32_t* cig_len, const char* cig_op,
             long ncig, const char* rna, const char* seq2, const char* src,
             long N, long dna_start_pos, long strand, long para, long nt_min,
             long nt_max, long penalty_t, long penalty_c,
             std::vector<Cand>& out) {
    const long qb = meta[3], rb = meta[1];
    std::string ref_a, read_a, src_a;
    long q = rb, p = qb;
    for (long k = 0; k < ncig; k++) {
        const long len = cig_len[k];
        const char op = cig_op[k];
        for (long f = 0; f < len; f++) {
            if (op == 'I') {
                ref_a += '-';
                src_a += '-';
                read_a += rna[p++];
            } else if (op == 'D') {
                ref_a += seq2[q];
                src_a += src[q];
                read_a += '-';
                q++;
            } else {
                ref_a += seq2[q];
                src_a += src[q];
                read_a += rna[p];
                q++;
                p++;
            }
        }
    }
    const long nt = (long)ref_a.size();
    long match = 0;
    for (long i = 0; i < nt; i++)
        if (ref_a[i] == read_a[i]) match++;
    const long mis = nt - match;
    const float identity = (float)(100 * match) / (float)(match + mis);
    float tri = 0.0f;
    if (nt_min <= nt && nt <= nt_max) {
        char prechar = '\0';
        float prescore = 0.0f;
        for (long i = 0; i < nt; i++) {
            const char curchar = ref_a[i] == '-' ? '-' : src_a[i];
            float hv = stab(curchar, read_a[i], para);
            if (curchar == prechar && curchar == 'T') {
                tri = (tri - prescore) + (float)penalty_t;
                hv = (float)penalty_t;
            }
            if (curchar == prechar && curchar == 'C') {
                tri = (tri - prescore) + (float)penalty_c;
                hv = (float)penalty_c;
            }
            prescore = hv;
            if (ref_a[i] != '-') prechar = curchar;
            tri = tri + hv;
        }
        tri = tri / (float)nt;
    }
    long ref_start, ref_end;
    if ((para > 0 && strand == 1) || (para < 0 && strand == 0)) {
        ref_start = N - meta[2] - 1;
        ref_end = N - meta[1] - 1;
    } else {
        ref_start = meta[1] + 1;
        ref_end = meta[2] + 1;
    }
    if (nt >= nt_min)
        out.push_back(Cand{(int32_t)(qb + 1), (int32_t)(meta[4] + 1),
                           (int32_t)(ref_start + dna_start_pos),
                           (int32_t)(ref_end + dna_start_pos), (int32_t)nt,
                           (float)meta[0], identity, tri, read_a, src_a});
}

}  // namespace

namespace {

// Peaks -> Iden sweep -> realign -> convert for one pair; appends Cands.
// Returns false on cigar-buffer overflow (cannot happen with cig_cap
// M+N+8, kept for safety).
bool pair_candidates(const int32_t* q_idx, long M, const int32_t* r_idx,
                     long N, const char* rna, const char* seq2,
                     const char* src, const int32_t* colmax,
                     const int32_t* mat, long mat_dim, long go, long ge,
                     long dna_start_pos, long min_score, long strand,
                     long para, long nt_min, long nt_max, long penalty_t,
                     long penalty_c, std::vector<Cand>& cands) {
    std::vector<std::pair<int32_t, long>> peaks;
    peaks_of(colmax, N, min_score, peaks);
    if (peaks.empty()) return true;
    const long cig_cap = M + N + 8;
    std::vector<int32_t> cig_len(cig_cap);
    std::vector<char> cig_op(cig_cap);
    std::vector<int32_t> bl_len(cig_cap);
    std::vector<char> bl_op(cig_cap);
    int32_t meta[5], bmeta[5];
    for (auto& pk : peaks) {
        const long score = pk.first;
        const long position = pk.second;
        // Iden sweep (fastsim.h:202-237): float32 window-size arithmetic
        float iden = 0.6f;
        long best_score = 0, best_ncig = 0, best_cutlength = 0;
        int myflag = 0;
        long ncig = 0, cutlength = 0;
        meta[0] = 0;
        while (iden <= 1) {
            cutlength =
                (long)((float)((float)(score + 24) / (9.0f * iden - 4.0f)) +
                       1.0f);
            if (position - cutlength + 1 <= 0) cutlength = position + 1;
            ncig = fasim::ssw_align_core(
                q_idx, M, r_idx + position - cutlength + 1, cutlength, mat,
                mat_dim, go, ge, meta, cig_len.data(), cig_op.data(),
                cig_cap);
            if (ncig == -2) return false;
            if (meta[0] >= score) {
                myflag = 1;
                break;
            }
            if (meta[0] > best_score && meta[2] == cutlength - 1) {
                best_score = meta[0];
                std::memcpy(bmeta, meta, sizeof(meta));
                std::memcpy(bl_len.data(), cig_len.data(),
                            ncig * sizeof(int32_t));
                std::memcpy(bl_op.data(), cig_op.data(), ncig);
                best_ncig = ncig;
                best_cutlength = cutlength;
                myflag = 2;
            }
            iden = iden + 0.1f;
        }
        if (myflag == 2) {
            std::memcpy(meta, bmeta, sizeof(meta));
            std::memcpy(cig_len.data(), bl_len.data(),
                        best_ncig * sizeof(int32_t));
            std::memcpy(cig_op.data(), bl_op.data(), best_ncig);
            ncig = best_ncig;
            cutlength = best_cutlength;
        }
        if (meta[0] != 0) {
            meta[1] += (int32_t)(position - cutlength + 1);
            meta[2] += (int32_t)(position - cutlength + 1);
            convert(meta, cig_len.data(), cig_op.data(), ncig, rna, seq2,
                    src, N, dna_start_pos, strand, para, nt_min, nt_max,
                    penalty_t, penalty_c, cands);
        }
    }
    return true;
}

// dedup chain + top-50 + final filter (fastsim.h:273-288), then write the
// survivors (with their scan index) into the output arrays.  ints layout
// per row: stari endi starj endj nt scan_idx.  Returns the new nout or -1.
long finish_pair(std::vector<Cand>& cands, long scan_idx, long nt_min,
                 float min_identity, float min_stability, long cap,
                 int32_t* ints, float* floats, int64_t* stroffs,
                 char* strbuf, long strbuf_cap, long nout, long* soff) {
    if (cands.empty()) return nout;
    const int32_t nc = (int32_t)cands.size();
    std::vector<int32_t> a(nc), b(nc), c(nc), d(nc), keep(nc);
    std::vector<float> s(nc);
    for (int32_t i = 0; i < nc; i++) {
        a[i] = cands[i].stari;
        b[i] = cands[i].endi;
        c[i] = cands[i].starj;
        d[i] = cands[i].endj;
        s[i] = cands[i].score;
    }
    const int32_t kept = lt_fastsim_dedup(a.data(), b.data(), c.data(),
                                          d.data(), s.data(), nc, keep.data());
    for (int32_t k = 0; k < kept && k < TOP_N; k++) {
        const Cand& t = cands[keep[k]];
        if (!(t.identity >= min_identity && t.tri >= min_stability &&
              t.nt >= nt_min))
            continue;
        if (nout >= cap) return -1;
        if (*soff + (long)t.ra.size() + (long)t.rsrc.size() > strbuf_cap)
            return -1;
        ints[nout * 6 + 0] = t.stari;
        ints[nout * 6 + 1] = t.endi;
        ints[nout * 6 + 2] = t.starj;
        ints[nout * 6 + 3] = t.endj;
        ints[nout * 6 + 4] = t.nt;
        ints[nout * 6 + 5] = (int32_t)scan_idx;
        floats[nout * 3 + 0] = t.score;
        floats[nout * 3 + 1] = t.identity;
        floats[nout * 3 + 2] = t.tri;
        stroffs[nout * 4 + 0] = *soff;
        stroffs[nout * 4 + 1] = (int64_t)t.ra.size();
        std::memcpy(strbuf + *soff, t.ra.data(), t.ra.size());
        *soff += t.ra.size();
        stroffs[nout * 4 + 2] = *soff;
        stroffs[nout * 4 + 3] = (int64_t)t.rsrc.size();
        std::memcpy(strbuf + *soff, t.rsrc.data(), t.rsrc.size());
        *soff += t.rsrc.size();
        nout++;
    }
    return nout;
}

}  // namespace

extern "C" {

// Peak extraction for one segment across all scans (the host-side prefix
// of the candidate stage when the window alignments run on device):
// per scan, byte-break the uint8 colmax row (sswNew.cpp:384-386), then
// run-cluster the above-threshold columns (preAlign, ssw_cpp.cpp:444-572).
// out rows: (scan_idx, score, position), scan-major (reference transform
// order).  Returns the peak count or -1 on overflow.
long lt_segment_peaks(const uint8_t* cm_u8, long cm_stride,
                      const int32_t* thresh, long nscans, long N,
                      int32_t* out, long cap) {
    std::vector<int32_t> cm(N);
    std::vector<std::pair<int32_t, long>> peaks;
    long nout = 0;
    for (long k = 0; k < nscans; k++) {
        const long min_score = (long)((double)thresh[k] * 0.8);
        const uint8_t* row = cm_u8 + (size_t)k * cm_stride;
        bool any = false;
        long stop = N;
        for (long j = 0; j < N; j++)
            if (row[j] >= 251) {
                stop = j;
                break;
            }
        for (long j = 0; j < stop; j++) {
            cm[j] = row[j];
            if (cm[j] > min_score) any = true;
        }
        for (long j = stop; j < N; j++) cm[j] = 0;
        if (!any) continue;
        peaks.clear();
        peaks_of(cm.data(), N, min_score, peaks);
        for (auto& pk : peaks) {
            if (nout >= cap) return -1;
            out[nout * 3 + 0] = (int32_t)k;
            out[nout * 3 + 1] = pk.first;
            out[nout * 3 + 2] = (int32_t)pk.second;
            nout++;
        }
    }
    return nout;
}

// Packed-candidate variant of lt_segment_peaks: the byte-break +
// threshold mask already ran on device; pos/val hold the first K
// above-threshold columns per scan and cnt the true count (callers
// handle cnt > K overflow rows separately before calling).  out rows:
// (scan_idx, score, position).  Returns the peak count or -1 on overflow.
long lt_segment_peaks_packed(const int16_t* pos, const uint8_t* val,
                             const int32_t* cnt, long nscans, long K,
                             int32_t* out, long cap) {
    std::vector<std::pair<int32_t, long>> peaks;
    long nout = 0;
    for (long k = 0; k < nscans; k++) {
        const long n = cnt[k] < K ? cnt[k] : K;
        if (!n) continue;
        peaks.clear();
        peaks_from_cands(pos + k * K, val + k * K, n, peaks);
        for (auto& pk : peaks) {
            if (nout >= cap) return -1;
            out[nout * 3 + 0] = (int32_t)k;
            out[nout * 3 + 1] = pk.first;
            out[nout * 3 + 2] = (int32_t)pk.second;
            nout++;
        }
    }
    return nout;
}

// Tail of the candidate stage for one (segment, transform) pair when the
// forward/reverse window passes already ran on device: per winning
// candidate (wins rows: score, ref_begin, ref_end, query_begin,
// query_end — segment-absolute, the reference's post-sweep meta,
// fastsim.h:250-255), banded_sw traceback + convertMyTriplex, then the
// dedup/top-50/filter chain.  ints layout per output row: stari endi
// starj endj nt scan_idx(0).  Returns the row count, -1 on buffer
// overflow, or -3 on a banded traceback error (caller re-runs the pair
// through lt_fastsim_pair).
long lt_finalize_pair(const int32_t* q_idx, long M, const int32_t* r_idx,
                      long N, const char* rna, const char* s2,
                      const char* src, const int32_t* wins, long nw,
                      const int32_t* mat, long mat_dim, long go, long ge,
                      long dna_start_pos, long strand, long para,
                      long nt_min, long nt_max, long penalty_t,
                      long penalty_c, float min_identity,
                      float min_stability, long cap, int32_t* ints,
                      float* floats, int64_t* stroffs, char* strbuf,
                      long strbuf_cap) {
    // Lazy finalize: the dedup chain's key (stari, endi, starj, endj,
    // score — fastsim.h:273-283) is PURE ARITHMETIC of the win meta
    // (convert's coordinate flip, fastsim.h:291-414), and whether a win
    // contributes a candidate at all is nt >= nt_min, where the cigar
    // length nt is bracketed by max(ref_len, read_len) <= nt <=
    // ref_len + read_len - 1.  So run dedup + the top-50 cap FIRST on
    // the predicted tuples and pay banded()+convert() only for (a) the
    // <= 50 survivors and (b) the rare bracket-ambiguous wins — on
    // MEG3-full this cuts the traceback/convert count ~4x with output
    // provably unchanged.  Conversions are cached per distinct tuple
    // (adjacent peaks converge to identical windows, measured 10.6%
    // duplicate rate).
    //
    // Caveat (documented divergence, theoretical only): a banded
    // traceback error in a win that dedup discards can no longer
    // trigger the -3 full-pair rerun; such an error has never been
    // observed on any golden or random differential input.
    // FASIM_EAGER_FINALIZE=1 converts every win eagerly (the original
    // contract) to re-verify that claim on new datasets.
    static const bool eager = [] {
        const char* e = std::getenv("FASIM_EAGER_FINALIZE");
        return e && e[0] == '1';
    }();
    struct Conv {
        bool has = false;
        Cand c;
    };
    std::map<std::array<int32_t, 5>, Conv> cache;
    const long cig_cap = M + N + 8;
    std::vector<int32_t> cig_len(cig_cap);
    std::vector<char> cig_op(cig_cap);
    std::vector<Cand> tmp;
    long err = 0;
    auto ensure = [&](const std::array<int32_t, 5>& key) -> Conv* {
        auto it = cache.find(key);
        if (it != cache.end()) return &it->second;
        int32_t meta[5] = {key[0], key[1], key[2], key[3], key[4]};
        const long rb = meta[1], re = meta[2], qb = meta[3], qe = meta[4];
        const long ref_len = re - rb + 1, read_len = qe - qb + 1;
        long ncig;
        int64_t s0 = -1;
        if (ref_len == read_len) {
            // Gap-free fast path: when the pure-diagonal score of the
            // begin..end rectangle equals the alignment score, banded()
            // provably emits exactly [ref_len, 'M'] and can be skipped.
            // Proof sketch (ties prefer the diagonal, align_core.h
            // banded(): dcode = t1 <= t2 ? 1 : ...): the forward pass
            // guarantees no local alignment inside the rectangle scores
            // above `score`, so with s0 == score every diagonal prefix
            // P(k) >= 0 and every diagonal cell has h(k,k) == P(k)
            // (<= from remaining-diagonal completion vs the score
            // bound, >= from the diagonal DP chain); hence t1 =
            // max(e1,f1) <= h(k,k) = t2 at every diagonal cell and the
            // traceback from the corner walks pure diagonal.  The
            // initial band (width 1) contains the diagonal, so no band
            // doubling or re-run occurs either.  Catches every
            // gap-free win (the common case) at O(len) cost.
            s0 = 0;
            for (long k = 0; k < ref_len; k++)
                s0 += mat[r_idx[rb + k] * mat_dim + q_idx[qb + k]];
        }
        if (s0 == (int64_t)meta[0]) {
            cig_len[0] = (int32_t)ref_len;
            cig_op[0] = 'M';
            ncig = 1;
        } else {
            long bw = ref_len - read_len;
            if (bw < 0) bw = -bw;
            bw += 1;
            ncig =
                fasim::banded(r_idx + rb, ref_len, q_idx + qb, read_len,
                              meta[0], go, ge, bw, mat, mat_dim,
                              cig_len.data(), cig_op.data(), cig_cap);
        }
        if (ncig < 0) {
            err = ncig;  // -1 traceback error, -2 overflow
            return nullptr;
        }
        tmp.clear();
        convert(meta, cig_len.data(), cig_op.data(), ncig, rna, s2, src,
                N, dna_start_pos, strand, para, nt_min, nt_max, penalty_t,
                penalty_c, tmp);
        Conv& cv = cache[key];
        if (!tmp.empty()) {
            cv.has = true;
            cv.c = std::move(tmp[0]);
        }
        return &cv;
    };
    // pass 1: predicted candidate tuples, in win order
    std::vector<int32_t> a, b, c, d;
    std::vector<float> s;
    std::vector<std::array<int32_t, 5>> keys;
    a.reserve(nw);
    b.reserve(nw);
    c.reserve(nw);
    d.reserve(nw);
    s.reserve(nw);
    keys.reserve(nw);
    for (long t = 0; t < nw; t++) {
        int32_t meta[5];
        std::memcpy(meta, wins + t * 5, sizeof(meta));
        const long rb = meta[1], re = meta[2], qb = meta[3], qe = meta[4];
        const long ref_len = re - rb + 1, read_len = qe - qb + 1;
        const long nt_hi = ref_len + read_len - 1;
        const long nt_lo = ref_len > read_len ? ref_len : read_len;
        const std::array<int32_t, 5> key =
            {meta[0], meta[1], meta[2], meta[3], meta[4]};
        bool member;
        if (eager) {
            const Conv* cv = ensure(key);
            if (!cv) return err == -1 ? -3 : -1;
            member = cv->has;
        } else if (nt_lo >= nt_min) {
            member = true;
        } else if (nt_hi < nt_min) {
            member = false;
        } else {
            const Conv* cv = ensure(key);  // bracket-ambiguous: resolve
            if (!cv) return err == -1 ? -3 : -1;
            member = cv->has;
        }
        if (!member) continue;
        long ref_start, ref_end;
        if ((para > 0 && strand == 1) || (para < 0 && strand == 0)) {
            ref_start = N - meta[2] - 1;
            ref_end = N - meta[1] - 1;
        } else {
            ref_start = meta[1] + 1;
            ref_end = meta[2] + 1;
        }
        a.push_back((int32_t)(qb + 1));
        b.push_back((int32_t)(qe + 1));
        c.push_back((int32_t)(ref_start + dna_start_pos));
        d.push_back((int32_t)(ref_end + dna_start_pos));
        s.push_back((float)meta[0]);
        keys.push_back(key);
    }
    if (keys.empty()) return 0;
    const int32_t nc = (int32_t)keys.size();
    std::vector<int32_t> keep(nc);
    const int32_t kept = lt_fastsim_dedup(a.data(), b.data(), c.data(),
                                          d.data(), s.data(), nc,
                                          keep.data());
    long nout = 0, soff = 0;
    for (int32_t k = 0; k < kept && k < TOP_N; k++) {
        const Conv* cv = ensure(keys[keep[k]]);
        if (!cv) return err == -1 ? -3 : -1;
        const Cand& t = cv->c;
        if (!(cv->has && t.identity >= min_identity &&
              t.tri >= min_stability && t.nt >= nt_min))
            continue;
        if (nout >= cap) return -1;
        if (soff + (long)t.ra.size() + (long)t.rsrc.size() > strbuf_cap)
            return -1;
        ints[nout * 6 + 0] = t.stari;
        ints[nout * 6 + 1] = t.endi;
        ints[nout * 6 + 2] = t.starj;
        ints[nout * 6 + 3] = t.endj;
        ints[nout * 6 + 4] = t.nt;
        ints[nout * 6 + 5] = 0;
        floats[nout * 3 + 0] = t.score;
        floats[nout * 3 + 1] = t.identity;
        floats[nout * 3 + 2] = t.tri;
        stroffs[nout * 4 + 0] = soff;
        stroffs[nout * 4 + 1] = (int64_t)t.ra.size();
        std::memcpy(strbuf + soff, t.ra.data(), t.ra.size());
        soff += t.ra.size();
        stroffs[nout * 4 + 2] = soff;
        stroffs[nout * 4 + 3] = (int64_t)t.rsrc.size();
        std::memcpy(strbuf + soff, t.rsrc.data(), t.rsrc.size());
        soff += t.rsrc.size();
        nout++;
    }
    return nout;
}

// Full fastSIM candidate stage for one (segment, transform) pair.
// ints layout per row: stari endi starj endj nt scan_idx(0).
// Returns the emitted triplex count, or -1 on buffer overflow.
long lt_fastsim_pair(const int32_t* q_idx, long M, const int32_t* r_idx,
                     long N, const char* rna, const char* seq2,
                     const char* src, const int32_t* colmax,
                     const int32_t* mat, long mat_dim, long go, long ge,
                     long dna_start_pos, long min_score, long strand,
                     long para, long nt_min, long nt_max, long penalty_t,
                     long penalty_c, float min_identity, float min_stability,
                     long cap, int32_t* ints, float* floats, int64_t* stroffs,
                     char* strbuf, long strbuf_cap) {
    std::vector<Cand> cands;
    if (!pair_candidates(q_idx, M, r_idx, N, rna, seq2, src, colmax, mat,
                         mat_dim, go, ge, dna_start_pos, min_score, strand,
                         para, nt_min, nt_max, penalty_t, penalty_c, cands))
        return -1;
    long soff = 0;
    return finish_pair(cands, 0, nt_min, min_identity, min_stability, cap,
                       ints, floats, stroffs, strbuf, strbuf_cap, 0, &soff);
}

}  // extern "C"
