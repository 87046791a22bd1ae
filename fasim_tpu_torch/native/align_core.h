// Shared native alignment core: exact emulation of the reference's
// forward/reverse striped-kernel passes and banded_sw traceback
// (sswNew.cpp:255-1259).  Used by the candidate-window aligner
// (ssw_align.cpp) and the fastSIM candidate stage (fastsim_stage.cpp).
// Semantics notes live in ssw_align.cpp.
#ifndef FASIM_ALIGN_CORE_H_
#define FASIM_ALIGN_CORE_H_

#include <cstdint>
#include <cstring>
#include <cstddef>

using std::size_t;
#include <vector>

namespace fasim {


constexpr int32_t BYTE_SAT = 251;  // bias 4, cap 255 (sswNew.cpp:386)
constexpr int64_t NEG = INT64_MIN / 2;

struct PassResult {
    int32_t best;
    long end_col;
    long end_read;
    bool saturated;
};

// One striped-kernel-equivalent pass.  ref_at(k) yields the ref code in
// scan order; returns the running max, the last strict-improvement column,
// and the lowest query row attaining the max there.
//
// Layout for throughput: the per-column update is split into a
// vectorizable phase (E update + diagonal candidate; no loop-carried
// dependence) over a transposed query profile, and a short sequential
// phase (the lazy-F running max, H commit, column max).  All cell values
// are far inside int32 range (max score 5 * min(M, N)).
template <typename RefAt>
PassResult sw_end_pass(const int32_t* query_idx, long M, RefAt ref_at,
                       long N, long go, long ge, const int32_t* mat,
                       long mat_dim, long lanes, bool byte_sat,
                       int32_t terminate, bool has_terminate) {
    const long pad = (lanes - (M % lanes)) % lanes;
    const long Mp = M + pad;
    std::vector<int32_t> H(Mp, 0), E(Mp, 0), T(Mp, 0), best_H;
    // transposed profile prof[r][i]; phantom pad rows score 0
    std::vector<int32_t> prof((size_t)mat_dim * Mp, 0);
    for (long r = 0; r < mat_dim; r++)
        for (long i = 0; i < M; i++)
            prof[(size_t)r * Mp + i] = mat[query_idx[i] * mat_dim + r];
    const int32_t goi = (int32_t)go, gei = (int32_t)ge;
    int32_t best = 0;
    long end_col = -1;
    bool have_best = false;
    for (long k = 0; k < N; k++) {
        const int32_t* __restrict pr = &prof[(size_t)ref_at(k) * Mp];
        int32_t* __restrict h = H.data();
        int32_t* __restrict e = E.data();
        int32_t* __restrict t = T.data();
        {
            int32_t e0 = E[0] - gei;
            const int32_t ho = H[0] - goi;
            if (ho > e0) e0 = ho;
            e[0] = e0;
            int32_t t0 = pr[0];  // diag above-left of row 0 is 0
            if (e0 > t0) t0 = e0;
            if (t0 < 0) t0 = 0;
            t[0] = t0;
        }
        for (long i = 1; i < Mp; i++) {
            int32_t ei = e[i] - gei;
            const int32_t ho = h[i] - goi;
            if (ho > ei) ei = ho;
            e[i] = ei;
            int32_t ti = h[i - 1] + pr[i];
            if (ei > ti) ti = ei;
            if (ti < 0) ti = 0;
            t[i] = ti;
        }
        int32_t f = INT32_MIN / 2;
        int32_t cm = 0;
        for (long i = 0; i < Mp; i++) {
            const int32_t ti = t[i];
            const int32_t hi = ti > f ? ti : f;
            h[i] = hi;
            if (hi > cm) cm = hi;
            const int32_t fn = f - gei;
            const int32_t fo = ti - goi;
            f = fn > fo ? fn : fo;
        }
        if (cm > best) {
            best = cm;
            if (byte_sat && best >= BYTE_SAT)
                return PassResult{best, end_col, -1, true};
            end_col = k;
            best_H.assign(H.begin(), H.begin() + M);
            have_best = true;
        }
        if (has_terminate && cm == terminate) break;
    }
    long end_read = M - 1;
    if (have_best) {
        for (long i = 0; i < M; i++)
            if (best_H[i] == best) {
                end_read = i;
                break;
            }
    }
    return PassResult{best, end_col, end_read, false};
}

// banded_sw (sswNew.cpp:1071-1259).  Returns cigar length, or -1 on
// traceback error, or -2 if the cigar buffer is too small.
inline long banded(const int32_t* ref_idx, long ref_len, const int32_t* read_idx,
            long read_len, int32_t score, long go, long ge, long band_width,
            const int32_t* mat, long mat_dim, int32_t* cig_len, char* cig_op,
            long cig_cap) {
    int64_t max_sc = 0;
    std::vector<int8_t> direction;
    long width_d = 0;
    for (;;) {
        const long width = band_width * 2 + 3;
        width_d = band_width * 2 + 1;
        std::vector<int64_t> h_b(width + 1, 0), e_b(width + 1, 0),
            h_c(width + 1, 0);
        direction.assign((size_t)read_len * width_d * 3, 0);
        long u = 0;
        for (long i = 0; i < read_len; i++) {
            long beg = i - band_width;
            if (beg < 0) beg = 0;
            long end = i + band_width;
            if (end > ref_len - 1) end = ref_len - 1;
            long edge = end + 1;
            if (edge > width - 1) edge = width - 1;
            int64_t f = 0;
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0;
            const long x0 = beg;  // max(i - band_width, 0)
            long x1 = i - 1 - band_width;
            if (x1 < 0) x1 = 0;
            int8_t* dline = &direction[(size_t)i * width_d * 3];
            for (long j = beg; j <= end; j++) {
                u = j - x0 + 1;
                const long e = j - x1 + 1;
                const long b = j - 1 - x0 + 1;
                const long d = j - 1 - x1 + 1;
                const long dd = (j - x0) * 3;
                int64_t t1 = i == 0 ? -(int64_t)go : h_b[e] - go;
                int64_t t2 = i == 0 ? -(int64_t)ge : e_b[e] - ge;
                e_b[u] = t1 > t2 ? t1 : t2;
                const int8_t de = t1 > t2 ? 3 : 2;
                dline[dd + 0] = de;
                t1 = h_c[b] - go;
                t2 = f - ge;
                f = t1 > t2 ? t1 : t2;
                const int8_t df = t1 > t2 ? 5 : 4;
                dline[dd + 1] = df;
                const int64_t e1 = e_b[u] > 0 ? e_b[u] : 0;
                const int64_t f1 = f > 0 ? f : 0;
                t1 = e1 > f1 ? e1 : f1;
                t2 = h_b[d] + mat[ref_idx[j] * mat_dim + read_idx[i]];
                h_c[u] = t1 > t2 ? t1 : t2;
                if (h_c[u] > max_sc) max_sc = h_c[u];
                dline[dd + 2] = t1 <= t2 ? 1 : (e1 > f1 ? de : df);
            }
            for (long z = 1; z <= u; z++) h_b[z] = h_c[z];
        }
        if (max_sc >= score) break;
        band_width *= 2;
    }
    // traceback (sswNew.cpp:1158-1238)
    long i = read_len - 1;
    long j = ref_len - 1;
    long e = 0;
    char op = 'M', prev_op = 'M';
    int layer = 2;
    long n = 0;
    auto emit = [&](long len, char o) -> bool {
        if (n >= cig_cap) return false;
        cig_len[n] = (int32_t)len;
        cig_op[n] = o;
        n++;
        return true;
    };
    while (i > 0) {
        long x = i - band_width;
        if (x < 0) x = 0;
        const int dcode = direction[(size_t)i * width_d * 3 + (j - x) * 3 +
                                    layer];
        switch (dcode) {
            case 1: i--; j--; layer = 2; op = 'M'; break;
            case 2: i--; layer = 0; op = 'I'; break;
            case 3: i--; layer = 2; op = 'I'; break;
            case 4: j--; layer = 1; op = 'D'; break;
            case 5: j--; layer = 2; op = 'D'; break;
            default: return -1;  // trace back error
        }
        if (op == prev_op) {
            e++;
        } else {
            if (!emit(e, prev_op)) return -2;
            prev_op = op;
            e = 1;
        }
    }
    if (op == 'M') {
        if (!emit(e + 1, op)) return -2;
    } else {
        if (!emit(e, op)) return -2;
        if (!emit(1, 'M')) return -2;
    }
    // ops were collected back-to-front
    for (long a = 0, b = n - 1; a < b; a++, b--) {
        int32_t tl = cig_len[a];
        cig_len[a] = cig_len[b];
        cig_len[b] = tl;
        char to = cig_op[a];
        cig_op[a] = cig_op[b];
        cig_op[b] = to;
    }
    return n;
}


// Full ssw_align emulation into caller buffers.  Returns cigar count,
// 0 with meta[0]==0 for no/failed alignment, -2 on cigar overflow.
inline long ssw_align_core(const int32_t* query_idx, long M,
                           const int32_t* ref_idx, long N,
                           const int32_t* mat, long mat_dim, long go,
                           long ge, int32_t* out_meta, int32_t* cig_len,
                           char* cig_op, long cig_cap) {
    out_meta[0] = 0;
    out_meta[1] = out_meta[2] = out_meta[3] = out_meta[4] = -1;
    auto fwd_at = [&](long k) { return (long)ref_idx[k]; };
    PassResult f = sw_end_pass(query_idx, M, fwd_at, N, go, ge, mat, mat_dim,
                               16, true, 0, false);
    bool sat = f.saturated;
    if (sat)
        f = sw_end_pass(query_idx, M, fwd_at, N, go, ge, mat, mat_dim, 8,
                        false, 0, false);
    if (f.best == 0) return 0;  // caller's sw_score != 0 test discards
    const long end_ref = f.end_col, end_read = f.end_read;
    // reverse pass on the [0..end_read] x [0..end_ref] rectangle
    std::vector<int32_t> rev_q(end_read + 1);
    for (long i = 0; i <= end_read; i++) rev_q[i] = query_idx[end_read - i];
    auto rev_at = [&](long k) { return (long)ref_idx[end_ref - k]; };
    PassResult r = sw_end_pass(rev_q.data(), end_read + 1, rev_at,
                               end_ref + 1, go, ge, mat, mat_dim,
                               sat ? 8 : 16, false, f.best, true);
    const long ref_begin = end_ref - r.end_col;
    const long query_begin = end_read - r.end_read;
    const int32_t score = r.best < f.best ? r.best : f.best;
    std::vector<int32_t> sub_ref(ref_idx + ref_begin, ref_idx + end_ref + 1);
    std::vector<int32_t> sub_read(query_idx + query_begin,
                                  query_idx + end_read + 1);
    long bw = (long)sub_ref.size() - (long)sub_read.size();
    if (bw < 0) bw = -bw;
    bw += 1;
    long ncig = banded(sub_ref.data(), sub_ref.size(), sub_read.data(),
                       sub_read.size(), score, go, ge, bw, mat, mat_dim,
                       cig_len, cig_op, cig_cap);
    if (ncig == -1) return 0;  // traceback error -> Alignment(sw_score=0)
    if (ncig == -2) return -2;
    out_meta[0] = score;
    out_meta[1] = (int32_t)ref_begin;
    out_meta[2] = (int32_t)end_ref;
    out_meta[3] = (int32_t)query_begin;
    out_meta[4] = (int32_t)end_read;
    return ncig;
}

}  // namespace fasim
#endif  // FASIM_ALIGN_CORE_H_
