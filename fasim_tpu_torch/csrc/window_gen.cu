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
// a best <= 0 gives (0, -1, m - 1).  Real rows must be < 65,536 (the row
// keys); longer queries take the int32 kernel of window.cu.
//
// What bounds it on this card: integer ALU throughput (no memory traffic
// beyond the window codes, the per-row inputs, the score table, an L1/L2
// hit, and the ends).  Design, K3's (window_fwd.cu) with a start row per
// window:
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
//    dispatch's short windows to its front.  The warp runs the
//    longest of its segments' sweeps (full-mask shuffles), guarded per lane
//    at its start, in offset mismatches and at its end, and unguarded, the
//    next row's table prefetched, while every lane of the warp is on a real
//    row past both its windows' offsets;
//  * the phantom rows [m, mreal) keep the packed max; a half keeps no
//    statistics past its own mreal (the guarded steps mask it; the
//    unguarded ones stop where either half's mreal or m comes first); the
//    sweep ends at the pair's larger mreal.  The cut and the ends come
//    from the per-column keys by
//    L-lane reductions: a min for the cut column, then a max of
//    (column max << 8) | (255 - column).
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
template <int C, int L>
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
  // real rows below rk count for both halves
  const int rk = ra >= 0 ? min(min(ma, mb), m) : m;
  const int top = ra >= 0 ? min(max(ma, mb), tab_rows) : 0;
  const unsigned zm = sa < sb ? kZeroB : (sb < sa ? kZeroA : 0u);
  // warp-uniform step counts: every lane is on a real row in [r1, rk) of
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
      if (i < m)
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
  // before it, and that column's lowest real row
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
template <int C, int L, int C1, int L1>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
window_gen_kernel(const uint8_t* __restrict__ codes, int stride,
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
    run_pairs<C1, L1>(warp * (kWarp / L1), lane, codes, stride, tab,
                      tab_rows, pr, order, 0, lo, m, out);
    return;
  }
  warp -= w0;
  if (lo + warp * 2 * (kWarp / L) >= rows) return;
  run_pairs<C, L>(warp * (kWarp / L), lane, codes, stride, tab, tab_rows,
                  pr, order, lo, rows, m, out);
}

}  // namespace

extern "C" {

// codes uint8[rows, Wp] (Wp in {64, 128, 256}); tab int8[tab_rows, 8]
// per-row score table with the zero-score code 7 (kernels/window.py:
// score_table), tab_rows > m; offs, mreals, terms and rlens int32[rows];
// order int32[rows] the rows in the order they are paired, sorted by
// offset, and n_first int32[1] the count of the short windows that lead
// it, rlen <= Wp / 2 for Wp 64 and <= 3 Wp / 4 otherwise
// (kernels/window.py:offset_order, K4_SHORT); out int32[rows, 3].  Needs
// m <= 65536.
int fasim_window_gen(const void* codes, int Wp, const void* tab,
                     int tab_rows, const void* offs, const void* mreals,
                     const void* terms, const void* rlens, const void* order,
                     const void* n_first, int rows, int m, void* out,
                     void* stream) {
  if (rows <= 0) return 0;
  if (order == nullptr || n_first == nullptr || m > 65536 || tab_rows <= m)
    return static_cast<int>(cudaErrorInvalidValue);
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
      window_gen_kernel<4, 16, 4, 8>
          <<<grid((rows + 7) / 8 + (rows + 3) / 4 + 1), block, 0, st>>>(
              c, Wp, t, tab_rows, pr, od, nf, rows, m, dst);
      break;
    case 128:  // 96 and 128 columns, 2 a warp
      window_gen_kernel<4, 32, 3, 32>
          <<<grid((rows + 1) / 2 + 1), block, 0, st>>>(
              c, Wp, t, tab_rows, pr, od, nf, rows, m, dst);
      break;
    case 256:  // 192 and 256 columns, 2 a warp
      window_gen_kernel<8, 32, 6, 32>
          <<<grid((rows + 1) / 2 + 1), block, 0, st>>>(
              c, Wp, t, tab_rows, pr, od, nf, rows, m, dst);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
