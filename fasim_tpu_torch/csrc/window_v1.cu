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
// Two kernels, routed by shape in kernels/window_v1.py:
//
// fasim_window_v1, the pass: window_pairs.cuh's sweep, K4's design (two
// windows a register in the s16x2 cell of window_s16.cuh, each swept from
// its own offset in a dispatch sorted by (short, offset), the ends reduced
// in the kernel), with v1's statistics: every row t < min(mreal, nq) is
// keyed, phantom rows too, as (H << 16) | (0xFFFF - t), which orders (H,
// -t) as v1's 20-bit key does (H <= 5 * min(m, 256) = 1,280); no packed
// max is kept.  v1's starting key 0xFFFFF - (m - 1) and the keys of the
// rows below off (H = 0) have no counterpart: they only decide columns
// whose max is 0, and a column whose max is 0 never reaches the ends (a
// best <= 0 gives (0, -1, m - 1)).  So keyed rows must be < 65,536: nq <=
// 65,536 or every mreal <= 65,536.  What bounds it on this card: integer
// ALU throughput, 6 operations per two cells and the row key's prmt and
// max a cell (no memory traffic beyond the window codes, the per-row
// inputs, the score table, an L1/L2 hit, and the ends).
//
// fasim_window_keys, the long-query kernel (keyed rows past 65,536): the
// keys int32[rows, W] of the contract above, the ends reduced by the
// caller (kernels/window_v1.py:v1_ends).  What bounds it on this card:
// integer ALU throughput, ~18 operations per cell and no memory traffic
// beyond the window codes, the query codes (L1 hits) and the keys.
// Design: one warp per kernel row, lane k owning C consecutive columns,
// the warp sweeping the query rows as a diagonal wavefront, H and E of the
// column left of a lane's block passed right by shuffles, F and the keys
// in registers.  A row of 128 lanes may hold two independent 64-column
// windows (subw = 64): no DP state crosses lane 64, each half has its own
// off and mreal, and each half-warp is a wavefront of its own (the
// shuffles run in 16-lane segments, so lane 16 starts window B's column
// 0).  Rows below off have H = 0, so their keys are 0xFFFFF - t, whose
// maximum 0xFFFFF (row 0) is the starting key whenever mreal > 0; the
// sweep starts at row off and stops at min(mreal, nq) (later rows change
// no key).
#include "window_pairs.cuh"

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGapOpen = 16;
constexpr int kGapExtend = 4;
constexpr int kNeg = -(1 << 30);
constexpr int kKeyBits = 20;
constexpr int kKeyMask = (1 << kKeyBits) - 1;

// C columns per lane; kLanes lanes per window (32: one window per row, 16:
// two 64-column windows per 128-column row).
template <int C, int kLanes>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
window_keys_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ qc, int nq,
                   const int32_t* __restrict__ offs,
                   const int32_t* __restrict__ mreals, int rows, int m,
                   int32_t* __restrict__ out) {
  constexpr int kWin = kWarp / kLanes;  // windows per row
  constexpr int W = kWarp * C;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // whole warps leave together
  const int sub = lane % kLanes;
  const int win = row * kWin + lane / kLanes;
  const int mreal = mreals[win];
  const int t0 = max(offs[win], 0);
  const int span = max(min(mreal, nq) - t0, 0);
  int steps = span;
  if (kWin == 2) steps = max(steps, __shfl_xor_sync(kFull, span, kLanes));
  const int init = mreal > 0 ? kKeyMask : kKeyMask - (m - 1);
  const int col0 = lane * C;
  int code[C], hup[C], f[C], key[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    code[k] = codes[(size_t)row * W + col0 + k];
    hup[k] = 0;  // H of the previous query row
    f[k] = kNeg;
    key[k] = init;
  }
  int out_h = 0, out_e = 0, prev_in_h = 0;
  for (int step = 0; step < steps + kLanes - 1; ++step) {
    int in_h = __shfl_up_sync(kFull, out_h, 1, kLanes);
    int in_e = __shfl_up_sync(kFull, out_e, 1, kLanes);
    const int i = step - sub;
    if (i >= 0 && i < span) {
      if (sub == 0) {  // column -1 of the window: H = E = 0
        in_h = 0;
        in_e = 0;
      }
      const int t = t0 + i;
      const int qt = qc[t];
      const bool live = t < m;
      const int hi = live ? (qt < 4 ? 5 : -4) : 0;
      const int lo = live ? -4 : 0;
      const int tkey = kKeyMask - t;
      int diag = prev_in_h;
      prev_in_h = in_h;
      int hl = in_h, el = in_e;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int sc = code[k] == qt ? hi : lo;
        const int ev = max(el - kGapExtend, hl - kGapOpen);
        const int fv = max(hup[k] - kGapOpen, f[k] - kGapExtend);
        const int hv = max(max(diag + sc, ev), max(fv, 0));
        diag = hup[k];
        hup[k] = hv;
        f[k] = fv;
        hl = hv;
        el = ev;
        key[k] = max(key[k], (hv << kKeyBits) + tkey);
      }
      out_h = hl;
      out_e = el;
    }
  }
#pragma unroll
  for (int k = 0; k < C; ++k) out[(size_t)row * W + col0 + k] = key[k];
}

template <int C, int kLanes>
int launch(const void* codes, const void* qc, int nq, const void* offs,
           const void* mreals, int rows, int m, void* out, void* stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  window_keys_kernel<C, kLanes>
      <<<grid, kWarp * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(qc),
          nq, static_cast<const int32_t*>(offs),
          static_cast<const int32_t*>(mreals), rows, m,
          static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes uint8[rows, Wp] (Wp in {64, 128, 256}); tab int8[>= tab_rows, 8]
// per-row score table with the zero-score code 7, scoring 0 on rows >= m
// (kernels/window.py:score_table); tab_rows the query rows nq of the
// pass; offs, mreals, terms and rlens int32[rows]; order and n_first K4's
// (kernels/window.py:offset_order, K4_SHORT); out int32[rows, 3].  Needs
// tab_rows > m and every keyed row min(mreal, tab_rows) - 1 < 65,536.
int fasim_window_v1(const void* codes, int Wp, const void* tab, int tab_rows,
                    const void* offs, const void* mreals, const void* terms,
                    const void* rlens, const void* order, const void* n_first,
                    int rows, int m, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (order == nullptr || n_first == nullptr || tab_rows <= m)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_pairs<true>(codes, Wp, tab, tab_rows, offs, mreals, terms,
                            rlens, order, n_first, rows, m, out, stream);
}

// codes uint8[rows, W] (W 128 or 256; subw 64 only with W 128: two
// windows per row); qc int32[nq] query codes (-1 past m); offs / mreals
// int32[rows * (W / (subw ? subw : W))] per window; out int32[rows, W].
int fasim_window_keys(const void* codes, int rows, int W, int subw,
                      const void* qc, int nq, const void* offs,
                      const void* mreals, int m, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (subw == 64 && W == 128)
    return launch<4, 16>(codes, qc, nq, offs, mreals, rows, m, out, stream);
  if (subw == 0 && W == 128)
    return launch<4, 32>(codes, qc, nq, offs, mreals, rows, m, out, stream);
  if (subw == 0 && W == 256)
    return launch<8, 32>(codes, qc, nq, offs, mreals, rows, m, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
