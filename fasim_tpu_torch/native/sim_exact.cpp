// Exact k-best local-alignment engine (the reference's -F / SIM path).
//
// Semantics match sim.h:410-1143 — a Huang-Miller style
// Smith-Waterman that carries (score, start_i, start_j) per cell, keeps the
// K=50 best distinct start points, extracts alignments best-first with a
// linear-space divide-and-conquer traceback that marks used cells, and
// recomputes the affected rectangle (expanded until it clears every other
// node's bounding box) before the next extraction.
//
// This is a fresh implementation of those semantics, including the quirks
// the output depends on (documented inline):
//   * the node threshold compares 10x-scaled cell scores against the raw
//     min_score (sim.h:562) while extraction breaks on score/10 (:597);
//   * tie-breaking prefers the larger (score, start_i, start_j) triple
//     (ORDER, sim.h:487-498);
//   * inside the main scans an excluded diagonal zeroes the cell (restart),
//     but inside diff it leaves the vertical-gap-open value in place
//     (DIAG keeps the previous expression value, sim.h:282,309);
//   * the TT-run split branch is dead code: its guard `num >= 0` (sim.h:695)
//     is always true, so every in-range alignment is emitted whole;
//   * score /= 10 is integer division (sim.h:731); tri_score divides by the
//     query-row count nt = endi-stari+1 (:595), not the alignment length;
//   * the re-add threshold `min` starts at 0 and becomes 1 after the first
//     re-added node, because addnode returns 1 (sim.h:147, :1137);
//   * eviction replaces the first lowest-score node even when the incoming
//     score is lower (sim.h:130-138).
//
// The reference leaves V rows for non-ACGT letters uninitialized (stack
// garbage, UB); here they score 0, the one place bit-parity is undefined.
//
// Build: g++ -O2 -fPIC -shared sim_exact.cpp -o _sim_exact.so

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr long KMAX = 50;  // sim.h:17  #define K 50

struct Node {
    long score, si, sj, ei, ej, top, bot, left, right;
};

// Lexicographic max on (score, start_i, start_j) — ORDER, sim.h:487-498.
inline void take_max(long& s1, long& x1, long& y1, long s2, long x2, long y2) {
    if (s1 < s2) {
        s1 = s2; x1 = x2; y1 = y2;
    } else if (s1 == s2) {
        if (x1 < x2) {
            x1 = x2; y1 = y2;
        } else if (x1 == x2 && y1 < y2) {
            y1 = y2;
        }
    }
}

struct Emit {
    long stari, endi, starj, endj, nt;
    float score, identity, tri_score;
    std::string ri, rj;
};

struct Engine {
    const char* A;  // 1-based query (rna)
    const char* B;  // 1-based reference (transformed dna)
    long M, N;
    long Q, R;  // gap open / extend in 10x units (120 / 40)
    long min_score;
    long V[128][128];
    std::vector<std::vector<long>> used;  // per query row: aligned-cell cols
    // DP scratch, reused across phases exactly like the reference arrays.
    // Per ref column (length N+1): cell value + vertical-gap value, each
    // with its propagated (start_i, start_j).
    std::vector<long> col_score, col_vgap, col_si, vgap_si;
    std::vector<long> col_sj, vgap_sj;
    // Rectangle-recompute row-boundary caches (length M+1): boundary
    // cell/gap values + their starts.
    std::vector<long> edge_score, edge_gap, edge_si, edge_sj;
    std::vector<long> edgeg_si, edgeg_sj;
    Node list[KMAX];
    long nnode = 0;
    // (si, sj) -> list index.  The add_node threshold quirk (c 10x-scaled
    // vs raw min_score, sim.h:562) makes the call stream dense (~10% of
    // all cells), and the reference's linear list scan is ~45% of the
    // forward-scan wall; the map makes the common resident-start hit O(1)
    // with semantics unchanged.
    std::unordered_map<long, long> node_idx;

    long start_key(long si, long sj) const { return si * (N + 2) + sj; }
    // edit script state (diff's sapp/last protocol, sim.h:177-196)
    std::vector<long> script;
    long last = 0;
    long gi = 0, gj = 0;  // global cursors (*pI, *pJ)

    bool cell_used(long i, long j) const {
        for (long v : used[i])
            if (v == j) return true;
        return false;
    }

    long gap(long k) const { return k <= 0 ? 0 : Q + R * k; }

    // sim.h:99-148.  Always returns 1 (feeds the re-add threshold quirk).
    long add_node(long c, long ci, long cj, long i, long j) {
        const auto it = node_idx.find(start_key(ci, cj));
        if (it != node_idx.end()) {
            Node& nd = list[it->second];
            if (nd.score < c) {
                nd.score = c;
                nd.ei = i;
                nd.ej = j;
            }
            if (nd.top > i) nd.top = i;
            if (nd.bot < i) nd.bot = i;
            if (nd.left > j) nd.left = j;
            if (nd.right < j) nd.right = j;
            return 1;
        }
        long slot;
        if (nnode == KMAX) {
            // replace the first lowest-score node unconditionally
            long low = 0;
            for (long d = 1; d < nnode; d++)
                if (list[d].score < list[low].score) low = d;
            slot = low;
            node_idx.erase(start_key(list[low].si, list[low].sj));
        } else {
            slot = nnode++;
        }
        list[slot] = Node{c, ci, cj, i, j, i, i, j, j};
        node_idx.emplace(start_key(ci, cj), slot);
        return 1;
    }

    // --- edit script ops (sim.h DEL/INS/REP macros) ---
    void op_del(long k) {
        gi += k;
        if (last < 0)
            last = (script.back() -= k);
        else {
            script.push_back(-k);
            last = -k;
        }
    }
    void op_ins(long k) {
        gj += k;
        if (last < 0) {
            // keep the trailing deletion last: overwrite it with the
            // insertion and re-append it (sim.h:185-191); last unchanged
            long tail = last;
            script.back() = k;
            script.push_back(tail);
        } else {
            script.push_back(k);
            last = k;
        }
    }
    void op_rep() {
        script.push_back(0);
        last = 0;
    }

    // Linear-space best-alignment traceback within one node's rectangle,
    // excluding already-used cells (sim.h:171-348).  a/b are positioned so
    // a[1]/b[1] is the first char of the subproblem; gi/gj hold the global
    // (row, col) already consumed.
    long diff(const char* a, const char* b, long m, long n, long tb, long te) {
        if (n <= 0) {
            if (m > 0) op_del(m);
            return -gap(m);
        }
        if (m <= 0) {
            op_ins(n);
            return -gap(n);
        }
        const long i0 = gi, j0 = gj;  // entry-time global offsets
        if (m == 1) {
            if (tb > te) tb = te;
            long midc = -(tb + R + gap(n));
            long midj = 0;
            const long* va = V[(unsigned char)a[1]];
            for (long j = 1; j <= n; j++) {
                if (cell_used(i0 + 1, j + j0)) continue;
                long c = va[(unsigned char)b[j]] - (gap(j - 1) + gap(n - j));
                if (c > midc) {
                    midc = c;
                    midj = j;
                }
            }
            if (midj == 0) {
                op_ins(n);
                op_del(1);
            } else {
                if (midj > 1) op_ins(midj - 1);
                op_rep();
                gi++;
                gj++;
                used[gi].push_back(gj);
                if (midj < n) op_ins(n - midj);
            }
            return midc;
        }
        long midi = m / 2;
        // forward half: col_score = best score ending at (midi, j), col_vgap with open gap
        col_score[0] = 0;
        long t = -Q;
        for (long j = 1; j <= n; j++) {
            col_score[j] = t = t - R;
            col_vgap[j] = t - Q;
        }
        t = -tb;
        for (long i = 1; i <= midi; i++) {
            long s = col_score[0];
            long c = col_score[0] = t = t - R;
            long e = t - Q;
            const long* va = V[(unsigned char)a[i]];
            for (long j = 1; j <= n; j++) {
                long d;
                if ((c = c - Q - R) > (e = e - R)) e = c;
                if ((c = col_score[j] - Q - R) > (d = col_vgap[j] - R)) d = c;
                if (!cell_used(i + i0, j + j0)) c = s + va[(unsigned char)b[j]];
                if (c < d) c = d;
                if (c < e) c = e;
                s = col_score[j];
                col_score[j] = c;
                col_vgap[j] = d;
            }
        }
        col_vgap[0] = col_score[0];
        // reverse half: col_si = best score starting at (midi, j)
        col_si[n] = 0;
        t = -Q;
        for (long j = n - 1; j >= 0; j--) {
            col_si[j] = t = t - R;
            vgap_si[j] = t - Q;
        }
        t = -te;
        for (long i = m - 1; i >= midi; i--) {
            long s = col_si[n];
            long c = col_si[n] = t = t - R;
            long e = t - Q;
            const long* va = V[(unsigned char)a[i + 1]];
            for (long j = n - 1; j >= 0; j--) {
                long d;
                if ((c = c - Q - R) > (e = e - R)) e = c;
                if ((c = col_si[j] - Q - R) > (d = vgap_si[j] - R)) d = c;
                if (!cell_used(i + 1 + i0, j + 1 + j0))
                    c = s + va[(unsigned char)b[j + 1]];
                if (c < d) c = d;
                if (c < e) c = e;
                s = col_si[j];
                col_si[j] = c;
                vgap_si[j] = d;
            }
        }
        vgap_si[n] = col_si[n];
        // pick the crossing column (type 2 = the gap spans the midline)
        long midc = col_score[0] + col_si[0];
        long midj = 0;
        int type = 1;
        for (long j = 0; j <= n; j++) {
            long c = col_score[j] + col_si[j];
            if (c >= midc)
                if (c > midc || (col_score[j] != col_vgap[j] && col_si[j] == vgap_si[j])) {
                    midc = c;
                    midj = j;
                }
        }
        for (long j = n; j >= 0; j--) {
            long c = col_vgap[j] + vgap_si[j] + Q;
            if (c > midc) {
                midc = c;
                midj = j;
                type = 2;
            }
        }
        if (type == 1) {
            diff(a, b, midi, midj, tb, Q);
            diff(a + midi, b + midj, m - midi, n - midj, Q, te);
        } else {
            diff(a, b, midi - 1, midj, tb, 0);
            op_del(2);
            diff(a + midi + 1, b + midj, m - midi - 1, n - midj, 0, te);
        }
        return midc;
    }

    // sim.h:350-388: walk the edit script into gapped strings + identity.
    float render(const char* a, const char* b, long m, long n,
                 std::string& ra, std::string& rb) {
        long i = 0, j = 0, match = 0, mis = 0;
        size_t sp = 0;
        ra.clear();
        rb.clear();
        while (i < m || j < n) {
            while (i < m && j < n && script[sp] == 0) {
                ++i;
                ++j;
                if (a[i] == b[j])
                    ++match;
                else
                    ++mis;
                ra += a[i];
                rb += b[j];
                sp++;
            }
            if (i < m || j < n) {
                long op = script[sp++];
                if (op > 0)
                    for (long f = 0; f < op; f++) {
                        ra += '-';
                        rb += b[++j];
                        ++mis;
                    }
                else
                    for (long f = 0; f < -op; f++) {
                        rb += '-';
                        ra += a[++i];
                        ++mis;
                    }
            }
        }
        return (float)(100 * match) / (float)(match + mis);
    }
};

// sim.h:72-97 — triplex stability contribution of (source char, rna char).
float stab_score(char c1, char c2, long para) {
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

// sim.h:150-169: does the rectangle [m1,mm]x[n1,nn] clear every remaining
// node's bounding box (after widening rl/cl to any overlapping start)?
bool clears_all(const Node* list, long nnode, long m1, long mm, long n1,
                long nn, long* rl, long* cl) {
    long i;
    for (i = 0; i < nnode; i++) {
        const Node& nd = list[i];
        if (nd.si <= mm && nd.sj <= nn && nd.bot >= m1 - 1 &&
            nd.right >= n1 - 1 && (nd.si < *rl || nd.sj < *cl)) {
            if (nd.si < *rl) *rl = nd.si;
            if (nd.sj < *cl) *cl = nd.sj;
            break;
        }
    }
    return i == nnode;
}

void run_sim(Engine& E, const std::string& src, long dna_start_pos,
             long strand, long para, long nt_min, long nt_max,
             long penalty_t, long penalty_c, std::vector<Emit>& out,
             const int32_t* cells = nullptr, long ncells = 0) {
    const char* A = E.A;
    const char* B = E.B;
    const long M = E.M, N = E.N, Q = E.Q, R = E.R;
    auto& col_score = E.col_score;
    auto& col_vgap = E.col_vgap;
    auto& col_si = E.col_si;  // start_i of col_score
    auto& vgap_si = E.vgap_si;  // start_i of col_vgap
    auto& col_sj = E.col_sj;  // start_j of col_score
    auto& vgap_sj = E.vgap_sj;  // start_j of col_vgap
    auto& edge_score = E.edge_score;
    auto& edge_gap = E.edge_gap;
    auto& edge_si = E.edge_si;
    auto& edge_sj = E.edge_sj;
    auto& edgeg_si = E.edgeg_si;
    auto& edgeg_sj = E.edgeg_sj;

    // ---- full forward scan with start propagation (sim.h:511-567) ----
    // With a device-computed cell stream (kernels/sim_dev.py), the scan
    // is skipped and add_node replays over the qualifying cells
    // (score > min_score) in the same scan order — node-list state
    // (creation order, eviction, bboxes) evolves identically.
    if (cells) {
        for (long z = 0; z < ncells; z++) {
            const int32_t* c5 = cells + z * 5;
            E.add_node(c5[0], c5[1], c5[2], c5[3], c5[4]);
        }
    } else {
    for (long j = 1; j <= N; j++) {
        col_score[j] = 0;
        col_si[j] = 0;
        col_sj[j] = j;
        col_vgap[j] = -Q;
        vgap_si[j] = 0;
        vgap_sj[j] = j;
    }
    for (long i = 1; i <= M; i++) {
        long c = 0, f = -Q, p = 0;
        long ci = i, fi = i, pi = i - 1;
        long cj = 0, fj = 0, pj = 0;
        const long* va = E.V[(unsigned char)A[i]];
        for (long j = 1; j <= N; j++) {
            long d, di, dj;
            f = f - R;
            c = c - Q - R;
            take_max(f, fi, fj, c, ci, cj);
            c = col_score[j] - Q - R;
            ci = col_si[j];
            cj = col_sj[j];
            d = col_vgap[j] - R;
            di = vgap_si[j];
            dj = vgap_sj[j];
            take_max(d, di, dj, c, ci, cj);
            c = E.cell_used(i, j) ? 0 : p + va[(unsigned char)B[j]];
            if (c <= 0) {
                c = 0;
                ci = i;
                cj = j;
            } else {
                ci = pi;
                cj = pj;
            }
            take_max(c, ci, cj, d, di, dj);
            take_max(c, ci, cj, f, fi, fj);
            p = col_score[j];
            col_score[j] = c;
            pi = col_si[j];
            pj = col_sj[j];
            col_si[j] = ci;
            col_sj[j] = cj;
            col_vgap[j] = d;
            vgap_si[j] = di;
            vgap_sj[j] = dj;
            if (c > E.min_score) E.add_node(c, ci, cj, i, j);
        }
    }
    }

    // ---- best-first extraction with rectangle recomputation ----
    long readd_floor = 0;  // `min` in the reference; 1 after first re-add
    for (long count = E.nnode - 1; count >= 0; count--) {
        // pop the (first) max-score node
        long best = 0;
        for (long i = 1; i < E.nnode; i++)
            if (E.list[i].score > E.list[best].score) best = i;
        Node cur = E.list[best];
        E.nnode--;
        E.node_idx.erase(E.start_key(cur.si, cur.sj));
        if (best != E.nnode) {
            E.list[best] = E.list[E.nnode];
            E.list[E.nnode] = cur;
            E.node_idx[E.start_key(E.list[best].si, E.list[best].sj)] = best;
        }
        long score = cur.score;
        long stari = cur.si + 1, starj = cur.sj + 1;
        long endi = cur.ei, endj = cur.ej;
        long m1 = cur.top, mm = cur.bot, n1 = cur.left, nn = cur.right;
        long rl = endi - stari + 1, cl = endj - starj + 1;
        long nt = rl;
        E.gi = stari - 1;
        E.gj = starj - 1;
        E.script.clear();
        E.last = 0;
        E.diff(A + stari - 1, B + starj - 1, rl, cl, Q, Q);
        if (score / 10.0 <= (double)E.min_score) break;
        std::string ra, rb;
        float identity = E.render(A + stari - 1, B + starj - 1, rl, cl, ra, rb);
        // (TT-run split skipped: the reference guard `num >= 0` always takes
        // the whole-alignment branch, sim.h:693-749)
        if (nt >= nt_min && nt <= nt_max) {
            float tri = 0.0f, prescore = 0.0f;
            char prechar = 0;
            std::string rsrc;
            long j = 0;
            for (size_t i = 0; i < rb.size(); i++) {
                char curchar;
                float hv;
                if (rb[i] == '-') {
                    curchar = '-';
                    hv = stab_score(curchar, ra[i], para);
                    rsrc += '-';
                } else {
                    curchar = src[starj + j - 1];
                    hv = stab_score(curchar, ra[i], para);
                    rsrc += curchar;
                    j++;
                }
                if (curchar == prechar && curchar == 'T') {
                    tri = tri - prescore + (float)penalty_t;
                    hv = (float)penalty_t;
                }
                if (curchar == prechar && curchar == 'C') {
                    tri = tri - prescore + (float)penalty_c;
                    hv = (float)penalty_c;
                }
                prescore = hv;
                if (rb[i] != '-') prechar = curchar;
                tri += hv;
            }
            score /= 10;  // integer division (sim.h:731)
            float final_score = (float)score;
            tri /= (float)nt;
            long ref_start, ref_end;
            if (para < 0 && strand == 0) {
                ref_start = N - endj + 1;
                ref_end = N - starj + 1;
            } else if (para > 0 && strand == 1) {
                ref_start = N - endj - 1;
                ref_end = N - starj - 1;
            } else {
                ref_start = starj;
                ref_end = endj;
            }
            out.push_back(Emit{stari, endi, ref_start + dna_start_pos,
                               ref_end + dna_start_pos, nt, final_score,
                               identity, tri, ra, rsrc});
        }
        if (!count) break;

        // ---- rebuild the DP state over the node's rectangle, expanded
        // until it clears every other node's bbox (sim.h:892-1141) ----
        bool flag = false;
        for (long j = nn; j >= n1; j--) {
            col_score[j] = 0;
            col_sj[j] = j;
            col_vgap[j] = -Q;
            vgap_sj[j] = j;
            col_si[j] = vgap_si[j] = mm + 1;
        }
        long ci = 0, cj = 0, di = 0, dj = 0, fi = 0, fj = 0;
        for (long i = mm; i >= m1; i--) {
            long c = 0, p = 0, f = -Q;
            ci = fi = i;
            long pi = i + 1;
            cj = fj = nn + 1;
            long pj = nn + 1;
            const long* va = E.V[(unsigned char)A[i]];
            for (long j = nn; j >= n1; j--) {
                long d;
                f = f - R;
                c = c - Q - R;
                take_max(f, fi, fj, c, ci, cj);
                c = col_score[j] - Q - R;
                ci = col_si[j];
                cj = col_sj[j];
                d = col_vgap[j] - R;
                di = vgap_si[j];
                dj = vgap_sj[j];
                take_max(d, di, dj, c, ci, cj);
                c = E.cell_used(i, j) ? 0 : p + va[(unsigned char)B[j]];
                if (c <= 0) {
                    c = 0;
                    ci = i;
                    cj = j;
                } else {
                    ci = pi;
                    cj = pj;
                }
                take_max(c, ci, cj, d, di, dj);
                take_max(c, ci, cj, f, fi, fj);
                p = col_score[j];
                col_score[j] = c;
                pi = col_si[j];
                pj = col_sj[j];
                col_si[j] = ci;
                col_sj[j] = cj;
                col_vgap[j] = d;
                vgap_si[j] = di;
                vgap_sj[j] = dj;
                if (c > readd_floor) flag = true;
            }
            edge_score[i] = col_score[n1];
            edge_si[i] = col_si[n1];
            edge_sj[i] = col_sj[n1];
            edge_gap[i] = f;
            edgeg_si[i] = fi;
            edgeg_sj[i] = fj;
        }
        for (rl = m1, cl = n1;;) {
            bool rflag = true, cflag = true;
            while ((rflag && m1 > 1) || (cflag && n1 > 1)) {
                if (rflag && m1 > 1) {
                    rflag = false;
                    m1--;
                    long c = 0, p = 0, f = -Q;
                    ci = fi = m1;
                    long pi = m1 + 1;
                    cj = fj = nn + 1;
                    long pj = nn + 1;
                    const long* va = E.V[(unsigned char)A[m1]];
                    for (long j = nn; j >= n1; j--) {
                        long d;
                        f = f - R;
                        c = c - Q - R;
                        take_max(f, fi, fj, c, ci, cj);
                        c = col_score[j] - Q - R;
                        ci = col_si[j];
                        cj = col_sj[j];
                        d = col_vgap[j] - R;
                        di = vgap_si[j];
                        dj = vgap_sj[j];
                        take_max(d, di, dj, c, ci, cj);
                        c = E.cell_used(m1, j) ? 0
                                                   : p + va[(unsigned char)B[j]];
                        if (c <= 0) {
                            c = 0;
                            ci = m1;
                            cj = j;
                        } else {
                            ci = pi;
                            cj = pj;
                        }
                        take_max(c, ci, cj, d, di, dj);
                        take_max(c, ci, cj, f, fi, fj);
                        p = col_score[j];
                        col_score[j] = c;
                        pi = col_si[j];
                        pj = col_sj[j];
                        col_si[j] = ci;
                        col_sj[j] = cj;
                        col_vgap[j] = d;
                        vgap_si[j] = di;
                        vgap_sj[j] = dj;
                        if (c > readd_floor) flag = true;
                        if (!rflag && ((ci > rl && cj > cl) ||
                                       (di > rl && dj > cl) ||
                                       (fi > rl && fj > cl)))
                            rflag = true;
                    }
                    edge_score[m1] = col_score[n1];
                    edge_si[m1] = col_si[n1];
                    edge_sj[m1] = col_sj[n1];
                    edge_gap[m1] = f;
                    edgeg_si[m1] = fi;
                    edgeg_sj[m1] = fj;
                    if (!cflag && ((ci > rl && cj > cl) ||
                                   (di > rl && dj > cl) ||
                                   (fi > rl && fj > cl)))
                        cflag = true;
                }
                if (cflag && n1 > 1) {
                    cflag = false;
                    n1--;
                    long c = 0, p = 0, f = -Q;
                    cj = fj = n1;
                    const long* va = E.V[(unsigned char)B[n1]];
                    ci = fi = mm + 1;
                    long pi = mm + 1;
                    long pj = n1 + 1;
                    for (long i = mm; i >= m1; i--) {
                        long d;
                        f = f - R;
                        c = c - Q - R;
                        take_max(f, fi, fj, c, ci, cj);
                        c = edge_score[i] - Q - R;
                        ci = edge_si[i];
                        cj = edge_sj[i];
                        d = edge_gap[i] - R;
                        di = edgeg_si[i];
                        dj = edgeg_sj[i];
                        take_max(d, di, dj, c, ci, cj);
                        c = E.cell_used(i, n1) ? 0
                                                   : p + va[(unsigned char)A[i]];
                        if (c <= 0) {
                            c = 0;
                            ci = i;
                            cj = n1;
                        } else {
                            ci = pi;
                            cj = pj;
                        }
                        take_max(c, ci, cj, d, di, dj);
                        take_max(c, ci, cj, f, fi, fj);
                        p = edge_score[i];
                        edge_score[i] = c;
                        pi = edge_si[i];
                        pj = edge_sj[i];
                        edge_si[i] = ci;
                        edge_sj[i] = cj;
                        edge_gap[i] = d;
                        edgeg_si[i] = di;
                        edgeg_sj[i] = dj;
                        if (c > readd_floor) flag = true;
                        if (!cflag && ((ci > rl && cj > cl) ||
                                       (di > rl && dj > cl) ||
                                       (fi > rl && fj > cl)))
                            cflag = true;
                    }
                    col_score[n1] = edge_score[m1];
                    col_si[n1] = edge_si[m1];
                    col_sj[n1] = edge_sj[m1];
                    col_vgap[n1] = f;
                    vgap_si[n1] = fi;
                    vgap_sj[n1] = fj;
                    if (!rflag && ((ci > rl && cj > cl) ||
                                   (di > rl && dj > cl) ||
                                   (fi > rl && fj > cl)))
                        rflag = true;
                }
            }
            if ((m1 == 1 && n1 == 1) ||
                clears_all(E.list, E.nnode, m1, mm, n1, nn, &rl, &cl))
                break;
        }
        m1--;
        n1--;
        if (flag) {
            // forward re-scan of the expanded rectangle, re-adding nodes
            for (long j = n1 + 1; j <= nn; j++) {
                col_score[j] = 0;
                col_si[j] = m1;
                col_sj[j] = j;
                col_vgap[j] = -Q;
                vgap_si[j] = m1;
                vgap_sj[j] = j;
            }
            for (long i = m1 + 1; i <= mm; i++) {
                long c = 0, p = 0, f = -Q;
                ci = fi = i;
                long pi = i - 1;
                cj = fj = n1;
                long pj = n1;
                const long* va = E.V[(unsigned char)A[i]];
                for (long j = n1 + 1; j <= nn; j++) {
                    long d;
                    f = f - R;
                    c = c - Q - R;
                    take_max(f, fi, fj, c, ci, cj);
                    c = col_score[j] - Q - R;
                    ci = col_si[j];
                    cj = col_sj[j];
                    d = col_vgap[j] - R;
                    di = vgap_si[j];
                    dj = vgap_sj[j];
                    take_max(d, di, dj, c, ci, cj);
                    c = E.cell_used(i, j) ? 0 : p + va[(unsigned char)B[j]];
                    if (c <= 0) {
                        c = 0;
                        ci = i;
                        cj = j;
                    } else {
                        ci = pi;
                        cj = pj;
                    }
                    take_max(c, ci, cj, d, di, dj);
                    take_max(c, ci, cj, f, fi, fj);
                    p = col_score[j];
                    col_score[j] = c;
                    pi = col_si[j];
                    pj = col_sj[j];
                    col_si[j] = ci;
                    col_sj[j] = cj;
                    col_vgap[j] = d;
                    vgap_si[j] = di;
                    vgap_sj[j] = dj;
                    if (c > readd_floor)
                        readd_floor = E.add_node(c, ci, cj, i, j);
                }
            }
        }
    }
}

}  // namespace

extern "C" {

static long sim_scan_impl(const char* rna, long M, const char* dnaT, long N,
                          const char* src, long dna_start_pos,
                          long min_score, long strand, long para,
                          long nt_min, long nt_max, long penalty_t,
                          long penalty_c, long cap, int32_t* ints,
                          float* floats, int64_t* stroffs, char* strbuf,
                          long strbuf_cap, const int32_t* cells,
                          long ncells) {
    Engine E;
    std::string qa, qb;
    qa.reserve(M + 1);
    qb.reserve(N + 1);
    qa.push_back(' ');
    qa.append(rna, M);
    qb.push_back(' ');
    qb.append(dnaT, N);
    E.A = qa.c_str();
    E.B = qb.c_str();
    E.M = M;
    E.N = N;
    // 10x-scaled scoring: match 50, mismatch -40, open 120, extend 40
    // (sim.h:470-475 with LongTarget's 5/-4/-12/-4 args)
    std::memset(E.V, 0, sizeof(E.V));
    const char ACGT[] = "ACGT";
    for (char x : ACGT)
        for (char y : ACGT)
            E.V[(int)x][(int)y] = x == y ? 50 : -40;
    E.Q = 120;
    E.R = 40;
    E.min_score = min_score;
    E.used.assign(M + 1, {});
    E.col_score.assign(N + 1, 0);
    E.col_vgap.assign(N + 1, 0);
    E.col_si.assign(N + 1, 0);
    E.vgap_si.assign(N + 1, 0);
    E.col_sj.assign(N + 1, 0);
    E.vgap_sj.assign(N + 1, 0);
    E.edge_score.assign(M + 1, 0);
    E.edge_gap.assign(M + 1, 0);
    E.edge_si.assign(M + 1, 0);
    E.edge_sj.assign(M + 1, 0);
    E.edgeg_si.assign(M + 1, 0);
    E.edgeg_sj.assign(M + 1, 0);
    E.script.reserve(M + N + 2);

    std::vector<Emit> out;
    std::string srcs(src, strlen(src));
    run_sim(E, srcs, dna_start_pos, strand, para, nt_min, nt_max, penalty_t,
            penalty_c, out, cells, ncells);

    if ((long)out.size() > cap) return -1;
    long soff = 0;
    for (size_t k = 0; k < out.size(); k++) {
        const Emit& t = out[k];
        ints[k * 5 + 0] = (int32_t)t.stari;
        ints[k * 5 + 1] = (int32_t)t.endi;
        ints[k * 5 + 2] = (int32_t)t.starj;
        ints[k * 5 + 3] = (int32_t)t.endj;
        ints[k * 5 + 4] = (int32_t)t.nt;
        floats[k * 3 + 0] = t.score;
        floats[k * 3 + 1] = t.identity;
        floats[k * 3 + 2] = t.tri_score;
        if (soff + (long)t.ri.size() + (long)t.rj.size() > strbuf_cap)
            return -1;
        stroffs[k * 4 + 0] = soff;
        stroffs[k * 4 + 1] = (int64_t)t.ri.size();
        std::memcpy(strbuf + soff, t.ri.data(), t.ri.size());
        soff += t.ri.size();
        stroffs[k * 4 + 2] = soff;
        stroffs[k * 4 + 3] = (int64_t)t.rj.size();
        std::memcpy(strbuf + soff, t.rj.data(), t.rj.size());
        soff += t.rj.size();
    }
    return (long)out.size();
}

// Run the exact engine on one (query, transformed ref, source ref) triple.
// Outputs are parallel arrays; strings go into strbuf at stroffs[4*k..].
// Returns the triplex count, or -1 if a buffer was too small.
long lt_sim_scan(const char* rna, long M, const char* dnaT, long N,
                 const char* src, long dna_start_pos, long min_score,
                 long strand, long para, long nt_min, long nt_max,
                 long penalty_t, long penalty_c, long cap, int32_t* ints,
                 float* floats, int64_t* stroffs, char* strbuf,
                 long strbuf_cap) {
    return sim_scan_impl(rna, M, dnaT, N, src, dna_start_pos, min_score,
                         strand, para, nt_min, nt_max, penalty_t,
                         penalty_c, cap, ints, floats, stroffs, strbuf,
                         strbuf_cap, nullptr, 0);
}

// Device-assisted variant: the forward scan already ran on device
// (kernels/sim_dev.py); cells = int32[ncells, 5] (c, ci, cj, i, j)
// qualifying cells in scan order, replayed through add_node before the
// extraction phase.  Output contract identical to lt_sim_scan.
long lt_sim_replay(const char* rna, long M, const char* dnaT, long N,
                   const char* src, long dna_start_pos, long min_score,
                   long strand, long para, long nt_min, long nt_max,
                   long penalty_t, long penalty_c, const int32_t* cells,
                   long ncells, long cap, int32_t* ints, float* floats,
                   int64_t* stroffs, char* strbuf, long strbuf_cap) {
    return sim_scan_impl(rna, M, dnaT, N, src, dna_start_pos, min_score,
                         strand, para, nt_min, nt_max, penalty_t,
                         penalty_c, cap, ints, floats, stroffs, strbuf,
                         strbuf_cap, cells, ncells);
}

}  // extern "C"
