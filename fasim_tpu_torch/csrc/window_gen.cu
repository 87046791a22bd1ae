// K4 window_gen: the batched candidate-window pass with per-row offsets,
// phantom bounds and terminate scores, returning the scan-order ends
// (best, end_col, end_row) of one affine-gap Smith-Waterman pass of the
// query against each window row, in 16-bit cells.
//
// Replaces fasim_tpu/kernels/tpu.py:_wscan_kernel (pallas_call in
// _wscan_call, ends in _ends_from_stats).  Contract
// (kernels/xla.py:window_pass_xla, kernels/window.py:window_pass_ref): s =
// hi if code == q else lo on query rows off <= i < m, 0 elsewhere
// (zero-profile prefix and phantom rows); the column max runs over rows <
// mreal; end_row is the lowest row in [off, m) attaining the max of the
// end column (kBig when only a phantom row attains it); end_col is the
// first column < rlen attaining the best; under terms >= 0 the columns
// after the first one whose max equals terms are cut off (sswNew.cpp:617);
// a best <= 0 gives (0, -1, m - 1).  At m <= 65,536 the sweep keys real
// rows in 16 bits; longer queries (m <= 2**20) take its long form, whose
// keys fold by chunks of 65,536 rows into (H << 20) | (0xFFFFF - row).
//
// What bounds it on this card: integer ALU throughput (no memory traffic
// beyond the window codes, the per-row inputs, the score table, an L1/L2
// hit, and the ends).  The design, shared with K6, is window_pairs.cuh's:
// two windows per register in the s16x2 cell, each swept from its own
// offset in a dispatch sorted by (short, offset), the ends reduced in the
// kernel; K4 keeps the phantom rows [m, mreal) as a packed max.
#include "window_pairs.cuh"

extern "C" {

// codes uint8[rows, Wp] (Wp in {64, 128, 256}); tab int8[tab_rows, 8]
// per-row score table with the zero-score code 7 (kernels/window.py:
// score_table), tab_rows > m; offs, mreals, terms and rlens int32[rows];
// order int32[rows] the rows in the order they are paired, sorted by
// offset, and n_first int32[1] the count of the short windows that lead
// it, rlen <= Wp / 2 for Wp 64 and <= 3 Wp / 4 otherwise
// (kernels/window.py:offset_order, K4_SHORT); wide 0 the 16-bit row keys,
// which need m <= 65,536, else the long form, which needs m <= 2**20; out
// int32[rows, 3].
int fasim_window_gen(const void* codes, int Wp, const void* tab,
                     int tab_rows, const void* offs, const void* mreals,
                     const void* terms, const void* rlens, const void* order,
                     const void* n_first, int rows, int m, int wide,
                     void* out, void* stream) {
  if (rows <= 0) return 0;
  if (order == nullptr || n_first == nullptr || tab_rows <= m ||
      m > (wide ? kLongRows : kChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_pairs<false>(codes, Wp, tab, tab_rows, offs, mreals, terms,
                             rlens, order, n_first, rows, m, wide, out,
                             stream);
}

}  // extern "C"
