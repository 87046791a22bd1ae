// K3 window_fwd: the uniform forward candidate-window pass, returning the
// scan-order ends (best, end_col, end_row) of one affine-gap
// Smith-Waterman pass of the query against each window row.
//
// Replaces fasim_tpu/kernels/tpu.py:_wfwd_kernel (pallas_call in
// _wfwd_call, ends in _ends_from_lane_keys).  Contract
// (kernels/window.py:window_pass_ref with off = 0, mreal = m16 and no
// terms): s = hi if code == q else lo on query rows i < m, 0 on the
// phantom rows m <= i < m16; the column max runs over rows < m16; end_row
// is the lowest row < m attaining the max of the end column (kBig when
// only a phantom row attains it); end_col is the first column < rlen
// attaining the best; a best <= 0 gives (0, -1, m - 1).
//
// What bounds it on this card: integer ALU throughput (no memory traffic
// beyond the window codes, the per-row score table, an L1/L2 hit, and the
// ends).  Design:
//  * two windows per 32-bit register in the s16x2 DPX forms, 6 operations
//    per two cells, with the score table, the selector and the row keys of
//    window_s16.cuh (shared with K4, window_gen.cu);
//  * every window of a dispatch reads the same query rows from row 0, so
//    one 8-byte table row serves both halves of every pair;
//  * lane k of an L-lane segment owns C consecutive columns and the
//    segment sweeps the query rows as a diagonal wavefront (lane k on row
//    step - k); G and E of the column left of a lane's block pass right by
//    shuffles inside the segment.  64-column windows take 16 lanes x 4
//    columns (four windows a warp), windows of rlen <= 32, which the
//    wrapper sorts to the front of a 64-column dispatch, 8 lanes x 4
//    columns (eight a warp), 128 and 256 32 lanes x 4 and x 8 (two a
//    warp);
//  * the sweep has three phases: the wavefront's start and its end
//    (guarded per lane), and the steps in between, where every lane is on
//    a real row and runs unguarded with the next row's table prefetched;
//  * the row keys hold rows in 16 bits: hence the engine's gate
//    m <= 65536.
#include "window_s16.cuh"

namespace {

using namespace fasim_s16;

constexpr int kWarpsPerBlock = 4;

// Windows [lo, hi) of the (possibly reordered) row list, two a segment of
// L lanes, starting with the warp's segment 0 at pair `first`.
template <int C, int L>
__device__ __forceinline__ void run_pairs(
    int first, int lane, const uint8_t* __restrict__ codes, int stride,
    const uint2* __restrict__ tab, const int32_t* __restrict__ rlens,
    const int32_t* __restrict__ order, int lo, int hi, int m, int m16,
    int32_t* __restrict__ out) {
  const int sub = lane % L;
  const int pos = lo + 2 * (first + lane / L);
  const int ra = pos < hi ? (order ? order[pos] : pos) : -1;
  const int rb = pos + 1 < hi ? (order ? order[pos + 1] : pos + 1) : -1;
  const int col0 = sub * C;
  Lane<C> w;
  w.init(codes, stride, ra, rb, col0);

  auto guarded = [&](int step) {
    unsigned in_g = __shfl_up_sync(kFull, w.out_g, 1, L);
    unsigned in_e = __shfl_up_sync(kFull, w.out_e, 1, L);
    const int i = step - sub;
    if (i >= 0 && i < m16) {
      if (sub == 0) {  // column -1: H = E = 0
        in_g = kM16;
        in_e = 0;
      }
      const uint2 t = tab[i];
      if (i < m)
        w.template row<true>(i, t, in_g, in_e);
      else
        w.template row<false>(i, t, in_g, in_e);
    }
  };
  const int nsteps = m16 + L - 1;
  int step = 0;
  for (; step < min(L - 1, nsteps); ++step) guarded(step);
  // every lane on a real row: no guards, the next row's table in flight
  if (step < m) {
    uint2 t = tab[step - sub];
    for (; step < m; ++step) {
      unsigned in_g = __shfl_up_sync(kFull, w.out_g, 1, L);
      unsigned in_e = __shfl_up_sync(kFull, w.out_e, 1, L);
      if (sub == 0) {
        in_g = kM16;
        in_e = 0;
      }
      const uint2 tn = tab[step + 1 - sub];
      w.template row<true>(step - sub, t, in_g, in_e);
      t = tn;
    }
  }
  for (; step < nsteps; ++step) guarded(step);

  // per half: first column attaining the best, and its lowest real row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    const int rlen = r >= 0 ? rlens[r] : 0;
    int key = 0, erow = kBig;  // key (column max << 8) | (255 - column)
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = col0 + k;
      int rmax, rrow, pmax;
      w.st[k].get(h, rmax, rrow, pmax);
      const int kk = max(rmax, pmax) << 8 | (255 - c);
      if (c < rlen && kk > key) {
        key = kk;
        erow = rmax >= pmax ? rrow : kBig;
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

// One kernel per (C, L).  With kFirstL, the rows [0, *n_first) of the
// reordered list take the layout (C, kFirstL) (32-column windows) and the
// rest (C, L); whole warps take one layout.
template <int C, int L, int kFirstL>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
window_fwd_kernel(const uint8_t* __restrict__ codes, int stride,
                  const uint2* __restrict__ tab,
                  const int32_t* __restrict__ rlens,
                  const int32_t* __restrict__ order,
                  const int32_t* __restrict__ n_first, int rows, int m,
                  int m16, int32_t* __restrict__ out) {
  int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  int lo = 0;
  if constexpr (kFirstL > 0) {
    lo = *n_first;
    constexpr int kPer = 2 * kWarp / kFirstL;  // windows a warp
    const int w0 = (lo + kPer - 1) / kPer;
    if (warp < w0) {
      run_pairs<C, kFirstL>(warp * (kWarp / kFirstL), lane, codes, stride,
                            tab, rlens, order, 0, lo, m, m16, out);
      return;
    }
    warp -= w0;
  }
  if (lo + warp * 2 * (kWarp / L) >= rows) return;
  run_pairs<C, L>(warp * (kWarp / L), lane, codes, stride, tab, rlens, order,
                  lo, rows, m, m16, out);
}

}  // namespace

extern "C" {

// codes uint8[rows, Wp] (Wp in {64, 128, 256}); tab int8[> m16, 8] per-row
// score table (kernels/window.py:score_table); rlens int32[rows]; with
// Wp 64 order int32[rows] and n_first int32[1] (kernels/window.py:
// pair_order): the rows in the order they are paired, the rlen <= 32 ones
// first, and their count (null otherwise: rows 2p and 2p + 1 pair);
// out int32[rows, 3].  Needs m <= 65536.
int fasim_window_fwd(const void* codes, int Wp, const void* tab,
                     const void* rlens, const void* order,
                     const void* n_first, int rows, int m, int m16,
                     void* out, void* stream) {
  if (rows <= 0) return 0;
  if ((order != nullptr) != (Wp == 64) || m > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  auto c = static_cast<const uint8_t*>(codes);
  auto t = static_cast<const uint2*>(tab);
  auto rl = static_cast<const int32_t*>(rlens);
  auto od = static_cast<const int32_t*>(order);
  auto nf = static_cast<const int32_t*>(n_first);
  auto dst = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 block(kWarp * kWarpsPerBlock);
  auto grid = [&](int warps) {
    return dim3((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  };
  switch (Wp) {
    case 64:
      // enough warps for any split (8 windows a 32-column warp, 4 a
      // 64-column one); the surplus leaves at once
      window_fwd_kernel<4, 16, 8>
          <<<grid((rows + 7) / 8 + (rows + 3) / 4 + 1), block, 0, st>>>(
              c, Wp, t, rl, od, nf, rows, m, m16, dst);
      break;
    case 128:
      window_fwd_kernel<4, 32, 0><<<grid((rows + 1) / 2), block, 0, st>>>(
          c, Wp, t, rl, od, nf, rows, m, m16, dst);
      break;
    case 256:
      window_fwd_kernel<8, 32, 0><<<grid((rows + 1) / 2), block, 0, st>>>(
          c, Wp, t, rl, od, nf, rows, m, m16, dst);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
