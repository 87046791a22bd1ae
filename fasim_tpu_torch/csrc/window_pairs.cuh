// The pair sweep of the general window passes, K4 (window_gen.cu) and K6
// (window_v1.cu): per-row offsets, statistics bounds (mreal) and terminate
// scores, two windows a 32-bit register in the 16-bit cell of
// window_s16.cuh, and the scan-order ends (best, end_col, end_row) reduced
// in the kernel.  The two passes differ only in the statistics of the rows
// m <= t < mreal (phantom rows, score 0), a compile-time policy kV1:
//  * K4 (kV1 false) keys the real rows t < min(mreal, m) and keeps a packed
//    max of the phantom rows; an end column attained only on a phantom row
//    gets end_row kBig (kernels/xla.py:window_pass_xla);
//  * K6 (kV1 true) keys every row t < mreal, phantom rows with their own
//    index (fasim_tpu/kernels/tpu.py:_window_kernel).
// The table's rows t >= m must score 0 (kernels/window.py:score_table).
//
// Design (K3's, window_fwd.cu, with a start row per window):
//  * two windows per 32-bit register in the s16x2 DPX forms, 6 operations
//    per two cells, with the score table, the selector and the row keys of
//    window_s16.cuh;
//  * every window sweeps from its own offset: rows below it score 0, so
//    its H is 0 there, and starting at the offset from the state of row -1
//    is exact.  The wrapper sorts each dispatch by offset on the device,
//    so most pairs share their start row.  A pair whose offsets differ
//    sweeps from the lower one, and the other half reads the zero-score
//    code 7 until its own offset;
//  * lane k of an L-lane segment owns C consecutive columns and the
//    segment sweeps its rows as a diagonal wavefront (lane k on row
//    start + step - k).  64-column windows take 16 lanes x 4 columns (four
//    windows a warp), windows of rlen <= 32 8 lanes x 4 (eight a warp),
//    128 and 256 32 lanes x 4 and x 8 (two a warp), and their windows of
//    rlen <= 96 and <= 192 32 lanes x 3 and x 6; the wrapper sorts each
//    dispatch's short windows to its front.  The warp runs the longest of
//    its segments' sweeps (full-mask shuffles), guarded per lane at its
//    start, in offset mismatches and at its end, and unguarded, the next
//    row's table prefetched, while every lane of the warp is on a keyed
//    row of both its windows past both offsets (K4: a real row below both
//    mreals; K6: any row below both mreals);
//  * a half keeps no statistics past its own mreal (the guarded steps mask
//    it); the sweep ends at the pair's larger mreal, or at tab_rows.  The
//    cut and the ends come from the per-column keys by L-lane reductions:
//    a min for the cut column, then a max of (column max << 8) |
//    (255 - column).
#pragma once

#include "window_s16.cuh"

namespace {

using namespace fasim_s16;

constexpr int kWarpsPerBlock = 4;

// per-window inputs, int32[rows] each
struct PerRow {
  const int32_t* offs;
  const int32_t* mreals;
  const int32_t* terms;
  const int32_t* rlens;
};

// Windows [lo, hi) of the reordered row list, two a segment of L lanes,
// starting with the warp's segment 0 at pair `first`.
template <int C, int L, bool kV1>
__device__ __forceinline__ void run_pairs(
    int first, int lane, const uint8_t* __restrict__ codes, int stride,
    const uint2* __restrict__ tab, int tab_rows, PerRow pr,
    const int32_t* __restrict__ order, int lo, int hi, int m,
    int32_t* __restrict__ out) {
  const int sub = lane % L;
  const int pos = lo + 2 * (first + lane / L);
  const int ra = pos < hi ? order[pos] : -1;  // ra < 0: no window at all
  const int rb = pos + 1 < hi ? order[pos + 1] : -1;
  // each half's start row (its offset, within [0, m]) and statistics
  // bound mreal; a missing B copies A, an empty segment sweeps nothing
  const int sa = ra >= 0 ? min(max(pr.offs[ra], 0), m) : 0;
  const int sb = rb >= 0 ? min(max(pr.offs[rb], 0), m) : sa;
  const int ma = ra >= 0 ? pr.mreals[ra] : 0;
  const int mb = rb >= 0 ? pr.mreals[rb] : ma;
  const int r0 = min(sa, sb);  // the pair's first row
  const int r1 = max(sa, sb);  // from here on both halves score
  // rows below rk are keyed for both halves (K4: real rows only; K6: its
  // bound keeps the unguarded steps' table prefetch inside the table)
  const int rk = ra >= 0 ? min(min(ma, mb), kV1 ? tab_rows - 1 : m) : m;
  const int top = ra >= 0 ? min(max(ma, mb), tab_rows) : 0;
  const unsigned zm = sa < sb ? kZeroB : (sb < sa ? kZeroA : 0u);
  // warp-uniform step counts: every lane is on a keyed row in [r1, rk) of
  // its pair for steps [fast_lo, fast_hi); the sweep ends at nsteps
  const int fast_lo = __reduce_max_sync(kFull, r1 - r0 + L - 1);
  const int fast_hi = __reduce_min_sync(kFull, rk - r0);
  const int nsteps = __reduce_max_sync(kFull, top - r0 + L - 1);

  const int col0 = sub * C;
  Lane<C> w;
  w.init(codes, stride, ra, rb, col0);
  const int base = r0 - sub;  // the lane's row at step 0

  auto guarded = [&](int step) {
    unsigned in_g = __shfl_up_sync(kFull, w.out_g, 1, L);
    unsigned in_e = __shfl_up_sync(kFull, w.out_e, 1, L);
    const int i = base + step;
    if (i >= r0 && i < top) {
      if (sub == 0) {  // column -1: H = E = 0
        in_g = kM16;
        in_e = 0;
      }
      const uint2 t = tab[i];
      const unsigned smask =
          (i < ma ? 0xFFFFu : 0u) | (i < mb ? 0xFFFF0000u : 0u);
      if (kV1 || i < m)
        w.template row<true>(i, t, in_g, in_e, i < r1 ? zm : 0u, smask);
      else
        w.template row<false>(i, t, in_g, in_e, 0u, smask);
    }
  };
  int step = 0;
  for (; step < min(fast_lo, nsteps); ++step) guarded(step);
  if (step < fast_hi) {
    uint2 t = tab[base + step];
    for (; step < fast_hi; ++step) {
      unsigned in_g = __shfl_up_sync(kFull, w.out_g, 1, L);
      unsigned in_e = __shfl_up_sync(kFull, w.out_e, 1, L);
      if (sub == 0) {
        in_g = kM16;
        in_e = 0;
      }
      const uint2 tn = tab[base + step + 1];
      w.template row<true>(base + step, t, in_g, in_e);
      t = tn;
    }
  }
  for (; step < nsteps; ++step) guarded(step);

  // per half: the cut column, then the first column attaining the best
  // before it, and that column's lowest keyed row (K6 keeps no packed max,
  // so pmax is 0 and the keyed max and row are the column's own)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    const int rlen = r >= 0 ? pr.rlens[r] : 0;
    const int term = r >= 0 ? pr.terms[r] : -1;
    int cmax[C], crow[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      int rmax, rrow, pmax;
      w.st[k].get(h, rmax, rrow, pmax);
      cmax[k] = max(rmax, pmax);
      crow[k] = rmax >= pmax ? rrow : kBig;
    }
    int first_eq = kBig;
#pragma unroll
    for (int k = C - 1; k >= 0; --k)
      if (term >= 0 && col0 + k < rlen && cmax[k] == term)
        first_eq = col0 + k;
    const int limit = seg_min<L>(first_eq);
    int key = 0, erow = kBig;  // key (column max << 8) | (255 - column)
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = col0 + k;
      const int kk = cmax[k] << 8 | (255 - c);
      if (c < rlen && c <= limit && kk > key) {
        key = kk;
        erow = crow[k];
      }
    }
    key = seg_max<L>(key);
    const int best = key >> 8;
    const int ecol = 255 - (key & 255);
    erow = __shfl_sync(kFull, erow, ecol / C, L);
    if (sub == 0 && r >= 0) {
      out[(size_t)r * 3] = best;
      out[(size_t)r * 3 + 1] = best > 0 ? ecol : -1;
      out[(size_t)r * 3 + 2] = best > 0 ? erow : m - 1;
    }
  }
}

// One kernel per width: the rows [0, *n_first) of the reordered list take
// the short layout (C1, L1) and the rest (C, L); whole warps take one
// layout.
template <int C, int L, int C1, int L1, bool kV1>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
window_pairs_kernel(const uint8_t* __restrict__ codes, int stride,
                    const uint2* __restrict__ tab, int tab_rows, PerRow pr,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ n_first, int rows, int m,
                    int32_t* __restrict__ out) {
  int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int lo = *n_first;
  constexpr int kPer = 2 * kWarp / L1;  // windows a warp
  const int w0 = (lo + kPer - 1) / kPer;
  if (warp < w0) {
    run_pairs<C1, L1, kV1>(warp * (kWarp / L1), lane, codes, stride, tab,
                           tab_rows, pr, order, 0, lo, m, out);
    return;
  }
  warp -= w0;
  if (lo + warp * 2 * (kWarp / L) >= rows) return;
  run_pairs<C, L, kV1>(warp * (kWarp / L), lane, codes, stride, tab,
                       tab_rows, pr, order, lo, rows, m, out);
}

// The launch of one dispatch of a width class Wp in {64, 128, 256} (the C
// entries' arguments; they check the rest).
template <bool kV1>
int launch_pairs(const void* codes, int Wp, const void* tab, int tab_rows,
                 const void* offs, const void* mreals, const void* terms,
                 const void* rlens, const void* order, const void* n_first,
                 int rows, int m, void* out, void* stream) {
  auto c = static_cast<const uint8_t*>(codes);
  auto t = static_cast<const uint2*>(tab);
  const PerRow pr{static_cast<const int32_t*>(offs),
                  static_cast<const int32_t*>(mreals),
                  static_cast<const int32_t*>(terms),
                  static_cast<const int32_t*>(rlens)};
  auto od = static_cast<const int32_t*>(order);
  auto nf = static_cast<const int32_t*>(n_first);
  auto dst = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 block(kWarp * kWarpsPerBlock);
  auto grid = [&](int warps) {
    return dim3((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  };
  switch (Wp) {
    // enough warps for any split; the surplus leaves at once
    case 64:  // 32 columns, 8 a warp; 64 columns, 4 a warp
      window_pairs_kernel<4, 16, 4, 8, kV1>
          <<<grid((rows + 7) / 8 + (rows + 3) / 4 + 1), block, 0, st>>>(
              c, Wp, t, tab_rows, pr, od, nf, rows, m, dst);
      break;
    case 128:  // 96 and 128 columns, 2 a warp
      window_pairs_kernel<4, 32, 3, 32, kV1>
          <<<grid((rows + 1) / 2 + 1), block, 0, st>>>(
              c, Wp, t, tab_rows, pr, od, nf, rows, m, dst);
      break;
    case 256:  // 192 and 256 columns, 2 a warp
      window_pairs_kernel<8, 32, 6, 32, kV1>
          <<<grid((rows + 1) / 2 + 1), block, 0, st>>>(
              c, Wp, t, tab_rows, pr, od, nf, rows, m, dst);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
