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
//  * two windows per 32-bit register: window A in the low half, B in the
//    high half, with Hopper's s16x2 DPX forms (as sw_colmax.cuh:CellS16x2).
//    A window's H never exceeds 5 * min(m, 256) = 1,280 and E and F never
//    fall below -20, so int16 is exact at every query length;
//  * every window of a dispatch reads the same query rows from row 0, so
//    one 8-byte table per query row (score + 16 of codes 0..7) serves both
//    halves: a score is one prmt by a per-column selector built once from
//    the two windows' codes;
//  * each column keeps G = H - 16 (the score table's +16 makes G the
//    diagonal operand), so E, F and H cost one DPX operation each and H - 16
//    one more: 6 operations per two cells;
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
//  * statistics without a branch: on real rows each half keeps a 32-bit
//    key (H << 16) | (0xFFFF - row) per column (a prmt and a max), whose
//    max is the column's real-row max and its lowest row; phantom rows
//    keep only a packed max.  Hence the engine's gate m <= 65536.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMin = 0x80008000u;  // -32768: max(x, kMin) = x
constexpr unsigned kM4 = 0xFFFCFFFCu;   // -4 in both halves
constexpr unsigned kM16 = 0xFFF0FFF0u;  // -16: G of row -1 and column -1
constexpr unsigned kTop = 0xC000C000u;  // -16384: F above row 0

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// the prmt selector of a column whose codes are ca (window A) and cb (B):
// each half gets the sign-extended table byte of its code
__device__ __forceinline__ unsigned selector(unsigned ca, unsigned cb) {
  return ca | (ca | 8) << 4 | cb << 8 | (cb | 8) << 12;
}

// A column's statistics for both windows: on real rows the keys
// (H << 16) | (0xFFFF - row), whose max holds the real-row max and its
// lowest row; on phantom rows the packed max.
struct ColStats {
  unsigned ka = 0, kb = 0, pm = 0;
  __device__ __forceinline__ void real(unsigned hv, unsigned tk) {
    ka = max(ka, prmt(tk, hv, 0x5410));
    kb = max(kb, prmt(tk, hv, 0x7610));
  }
  __device__ __forceinline__ void phantom(unsigned hv) {
    pm = __vimax_s16x2_relu(pm, hv);
  }
  // (real-row max, its lowest row, phantom-row max) of half h
  __device__ __forceinline__ void get(int h, int& rmax, int& rrow,
                                      int& pmax) const {
    const unsigned k = h ? kb : ka;
    rmax = static_cast<int>(k >> 16);
    rrow = 0xFFFF - static_cast<int>(k & 0xFFFFu);
    pmax = static_cast<int>((pm >> (16 * h)) & 0xFFFFu);
  }
};

// One lane's share of a pair of windows: C columns of both.
template <int C, int L>
struct Lane {
  unsigned sel[C], g[C], f[C];
  ColStats st[C];
  unsigned out_g = kM16, out_e = 0, prev_in_g = kM16;

  // query row i (table t) with the left column's G and E
  template <bool kReal>
  __device__ __forceinline__ void row(int i, uint2 t, unsigned in_g,
                                      unsigned in_e) {
    unsigned diag = prev_in_g;
    prev_in_g = in_g;
    unsigned gl = in_g, el = in_e;
    const unsigned tk = 0xFFFFu - static_cast<unsigned>(i);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const unsigned sc = prmt(t.x, t.y, sel[k]);      // s + 16
      el = __viaddmax_s16x2(el, kM4, gl);              // E
      const unsigned tmp = __viaddmax_s16x2_relu(diag, sc, el);
      f[k] = __viaddmax_s16x2(f[k], kM4, g[k]);        // F
      const unsigned hv = __vimax_s16x2_relu(tmp, f[k]);  // H
      diag = g[k];
      gl = __viaddmax_s16x2(hv, kM16, kMin);           // H - 16
      g[k] = gl;
      if (kReal)
        st[k].real(hv, tk);
      else
        st[k].phantom(hv);
    }
    out_g = gl;
    out_e = el;
  }
};

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
  Lane<C, L> w;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const unsigned ca = ra >= 0 ? codes[(size_t)ra * stride + col0 + k] : 4;
    const unsigned cb = rb >= 0 ? codes[(size_t)rb * stride + col0 + k] : 4;
    w.sel[k] = selector(ca, cb);
    w.g[k] = kM16;
    w.f[k] = kTop;
  }

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
#pragma unroll
    for (int d = L / 2; d > 0; d /= 2)
      key = max(key, __shfl_xor_sync(kFull, key, d, L));
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
