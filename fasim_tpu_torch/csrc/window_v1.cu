// K6: the v1 candidate-window pass (FASIM_WIN_V1=1), returning the
// scan-order ends (best, end_col, end_row) of one affine-gap
// Smith-Waterman pass of the query against each window.
//
// Replaces fasim_tpu/kernels/tpu.py:_window_kernel (pallas_call in
// _window_call; callers window_pass, _window_specs_call and
// _window_specs_call2 under FASIM_WIN_V1=1) and the ends glue after it
// (_decode_key, _ends_from_stats).  Contract: per window column, the key
//   max over rows t < min(mreal, nq) of (H(t, col) << 20) + (0xFFFFF - t),
// where H is the exact DP (gap open 16, extend 4) of the query codes q[t]
// (-1 past m) against the window's codes, with s = 5 iff code == q[t] and
// q[t] < 4, else -4, and s = 0 on rows t < off and t >= m (zero-profile
// prefix rows and phantom rows, which count with their own row index);
// then the ends as _ends_from_stats takes them from the keys: the columns
// after the first one < rlen whose max equals terms (terms >= 0) are cut,
// end_col is the first column < rlen attaining the best, end_row the
// first row attaining that column's max, and a best <= 0 gives (0, -1,
// m - 1).
//
// The kernel, fasim_window_v1: window_pairs.cuh's sweep, K4's design (two
// windows a register in the s16x2 cell of window_s16.cuh, each swept from
// its own offset in a dispatch sorted by (short, offset), the ends reduced
// in the kernel), with v1's statistics: every row t < min(mreal, nq) is
// keyed, phantom rows too, as (H << 16) | (0xFFFF - t), which orders (H,
// -t) as v1's 20-bit key does (H <= 5 * min(m, 256) = 1,280); no packed
// max is kept.  v1's starting key 0xFFFFF - (m - 1) and the keys of the
// rows below off (H = 0) have no counterpart: they only decide columns
// whose max is 0, and a column whose max is 0 never reaches the ends (a
// best <= 0 gives (0, -1, m - 1)).  Query rows nq past 65,536 take the
// sweep's long form (kernels/window_v1.py routes by nq), whose row keys
// fold by chunks of 65,536 rows into v1's own key (H << 20) | (0xFFFFF -
// t), so nq <= 2**20 as in v1.  What bounds it on this card: integer ALU
// throughput, 6 operations per two cells and the row key's prmt and max a
// cell (no memory traffic beyond the window codes, the per-row inputs, the
// score table, an L1/L2 hit, and the ends).
#include "window_pairs.cuh"

#include <cuda_runtime.h>

#include <cstdint>

extern "C" {

// codes uint8[rows, Wp] (Wp in {64, 128, 256}); tab int8[>= tab_rows, 8]
// per-row score table with the zero-score code 7, scoring 0 on rows >= m
// (kernels/window.py:score_table); tab_rows the query rows nq of the
// pass; offs, mreals, terms and rlens int32[rows]; order and n_first K4's
// (kernels/window.py:offset_order, K4_SHORT); wide 0 the 16-bit row keys,
// which need tab_rows <= 65,536, else the long form, which needs tab_rows
// <= 2**20; out int32[rows, 3].  Needs tab_rows > m.
int fasim_window_v1(const void* codes, int Wp, const void* tab, int tab_rows,
                    const void* offs, const void* mreals, const void* terms,
                    const void* rlens, const void* order, const void* n_first,
                    int rows, int m, int wide, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (order == nullptr || n_first == nullptr || tab_rows <= m ||
      tab_rows > (wide ? kLongRows : kChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_pairs<true>(codes, Wp, tab, tab_rows, offs, mreals, terms,
                            rlens, order, n_first, rows, m, wide, out,
                            stream);
}

}  // extern "C"
