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
//
// Queries past 65,536 keyed rows (the long form, kLong; the wrappers take
// it when m (K4) or the query rows (K6) pass 65,536): the cell step and its
// 16-bit row keys stay as they are, and the keys fold by chunk.  A row
// key's low half is 0xFFFF - i mod 2**16, so the keys of the rows [cb, cb
// + 65,536) (a chunk, cb a multiple of 65,536) order (H, -row) within it.
// At the first row of each later chunk a lane folds its keys into a
// running best in the wide key (H << 20) | (0xFFFFF - row), K6's own
// contract key (H <= 1,280 < 2**11, so it fits an int32), whose max keeps
// the lower row on a tie, and starts the chunk's keys afresh (K4 folds on
// real rows only: its phantom rows keep the packed max).  The ends read
// the max of the running best and the last chunk's keys.  The fold is a
// guarded step: the unguarded run stops where a lane of the warp meets a
// chunk start, about once a chunk, and resumes after the warp's last lane
// has.  Cost: registers (the running best, 2 * C a lane, and the split
// run; ptxas on sm_90a: K4 63 / 63 / 80 -> 72 / 72 / 117 at 64 / 128 / 256
// columns, K6 56 / 56 / 72 -> 72 / 72 / 95); the unguarded steps keep their
// 5 operations a cell.  Rows must be < 2**20 (the wide key).  A wide key
// in every cell step (2 operations a cell more) was the other design; the
// fold leaves the step as it is.  At a 91 kb query on a small DNA the
// dispatches leave the card mostly idle and a warp's serial sweep, a step
// every ~110-130 ns, sets the time; more operations a step would not help
// there, so the fold stays.
#pragma once

#include "window_s16.cuh"

namespace {

using namespace fasim_s16;

constexpr int kWarpsPerBlock = 4;
constexpr int kChunk = 1 << 16;    // rows a 16-bit row key tells apart
constexpr int kLongRows = 1 << 20;  // rows the long form's wide key holds

// the wide key (H << 20) | (0xFFFFF - t) of a chunk key k = (H << 16) |
// (0xFFFF - (t - cb)) of the chunk from row cb; 0 for no key
__device__ __forceinline__ unsigned wide_key(unsigned k, int cb) {
  return k ? ((k >> 16) << 20) + (0xF0000u - cb) + (k & 0xFFFFu) : 0u;
}

// per-window inputs, int32[rows] each
struct PerRow {
  const int32_t* offs;
  const int32_t* mreals;
  const int32_t* terms;
  const int32_t* rlens;
};

// Windows [lo, hi) of the reordered row list, two a segment of L lanes,
// starting with the warp's segment 0 at pair `first`.
template <int C, int L, bool kV1, bool kLong>
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
  // kLong: w's keys hold the rows of the chunk from cb, wide[h][k] the
  // best of the chunks before it
  int cb = r0 & ~(kChunk - 1);
  unsigned wide[2][kLong ? C : 1] = {};
  auto fold = [&](int i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      wide[0][k] = max(wide[0][k], wide_key(w.st[k].ka, cb));
      wide[1][k] = max(wide[1][k], wide_key(w.st[k].kb, cb));
      w.st[k].ka = w.st[k].kb = 0;
    }
    cb = i;
  };

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
      if (kLong && (i & (kChunk - 1)) == 0 && i != cb && (kV1 || i < m))
        fold(i);  // the first row of a later chunk
      if (kV1 || i < m)
        w.template row<true>(i, t, in_g, in_e, i < r1 ? zm : 0u, smask);
      else
        w.template row<false>(i, t, in_g, in_e, 0u, smask);
    }
  };
  int step = 0;
  // steps [step, stop) unguarded, the next row's table prefetched: every
  // lane of the warp on a keyed row past both offsets (and, kLong, in the
  // chunk of its previous row)
  auto fast = [&](int stop) {
    if (step < stop) {
      uint2 t = tab[base + step];
      for (; step < stop; ++step) {
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
  };
  for (; step < min(fast_lo, nsteps); ++step) guarded(step);
  if (!kLong) {
    fast(fast_hi);
  } else {
    // a lane meets the chunk start B on step B - base, so the warp's lanes
    // (those with a window) on steps [B - bmax, B - bmin]: those run
    // guarded, and no unguarded step crosses a chunk start
    const int bmin = __reduce_min_sync(kFull, ra >= 0 ? base : kBig);
    const int bmax = __reduce_max_sync(kFull, ra >= 0 ? base : -kBig);
    while (step < fast_hi) {
      // the first chunk start at or past the lowest lane's row
      const int B = ((bmin + step - 1) | (kChunk - 1)) + 1;
      fast(min(fast_hi, B - bmax));
      for (const int e = min(fast_hi, B - bmin + 1); step < e; ++step)
        guarded(step);
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
      if (kLong) {  // the wide keys of the earlier chunks and the last one
        const unsigned key =
            max(wide[h][k], wide_key(h ? w.st[k].kb : w.st[k].ka, cb));
        rmax = static_cast<int>(key >> 20);
        rrow = 0xFFFFF - static_cast<int>(key & 0xFFFFFu);
      }
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

// One kernel per width and form: the rows [0, *n_first) of the reordered
// list take the short layout (C1, L1) and the rest (C, L); whole warps
// take one layout.
template <int C, int L, int C1, int L1, bool kV1, bool kLong>
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
    run_pairs<C1, L1, kV1, kLong>(warp * (kWarp / L1), lane, codes, stride,
                                  tab, tab_rows, pr, order, 0, lo, m, out);
    return;
  }
  warp -= w0;
  if (lo + warp * 2 * (kWarp / L) >= rows) return;
  run_pairs<C, L, kV1, kLong>(warp * (kWarp / L), lane, codes, stride, tab,
                              tab_rows, pr, order, lo, rows, m, out);
}

// The launch of one dispatch of a width class Wp in {64, 128, 256} in one
// form (the C entries' arguments; they check the rest).
template <bool kV1, bool kLong>
int launch_form(const void* codes, int Wp, const void* tab, int tab_rows,
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
      window_pairs_kernel<4, 16, 4, 8, kV1, kLong>
          <<<grid((rows + 7) / 8 + (rows + 3) / 4 + 1), block, 0, st>>>(
              c, Wp, t, tab_rows, pr, od, nf, rows, m, dst);
      break;
    case 128:  // 96 and 128 columns, 2 a warp
      window_pairs_kernel<4, 32, 3, 32, kV1, kLong>
          <<<grid((rows + 1) / 2 + 1), block, 0, st>>>(
              c, Wp, t, tab_rows, pr, od, nf, rows, m, dst);
      break;
    case 256:  // 192 and 256 columns, 2 a warp
      window_pairs_kernel<8, 32, 6, 32, kV1, kLong>
          <<<grid((rows + 1) / 2 + 1), block, 0, st>>>(
              c, Wp, t, tab_rows, pr, od, nf, rows, m, dst);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch of one dispatch: the long form when `wide`, else the 16-bit
// row keys (the entries check the rows each form takes).
template <bool kV1>
int launch_pairs(const void* codes, int Wp, const void* tab, int tab_rows,
                 const void* offs, const void* mreals, const void* terms,
                 const void* rlens, const void* order, const void* n_first,
                 int rows, int m, int wide, void* out, void* stream) {
  return wide ? launch_form<kV1, true>(codes, Wp, tab, tab_rows, offs,
                                       mreals, terms, rlens, order, n_first,
                                       rows, m, out, stream)
              : launch_form<kV1, false>(codes, Wp, tab, tab_rows, offs,
                                        mreals, terms, rlens, order,
                                        n_first, rows, m, out, stream);
}

}  // namespace
