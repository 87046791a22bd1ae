// The 16-bit window cell shared by K3 (window_fwd.cu) and K4
// (window_gen.cu): two windows per 32-bit register with Hopper's s16x2 DPX
// forms, window A in the low half and B in the high half.
//
// A window's H never exceeds 5 * min(m, 256) = 1,280 and E and F never fall
// below -20, so int16 is exact at every query length.  Each column keeps
// G = H - 16 against a per-query-row score table of s + 16 (TABLE_BIAS in
// kernels/window.py), so G is the diagonal operand and E, F, H and G cost
// one DPX operation each: 6 operations per two cells.  A score is one prmt
// of the row's 8-byte table (codes 0..7) by a per-column selector built
// once from the two windows' codes.  Code 7 (ZERO_CODE) scores 0 on every
// row; OR-ing kZeroA or kZeroB into a selector makes that half score 0
// whatever its code (the rows below a window's offset).
//
// Statistics without a branch: on real rows each half keeps a 32-bit key
// (H << 16) | (0xFFFF - row mod 65,536) per column (a prmt and a max),
// whose max is the column's real-row max and its lowest row among rows
// that agree above their low 16 bits: all of them below 65,536 (K3, and
// K4 and K6 at m <= 65,536); the long form of window_pairs.cuh folds the
// keys by chunks of 65,536 rows.  Phantom rows keep only a packed max.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fasim_s16 {

constexpr int kWarp = 32;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMin = 0x80008000u;  // -32768: max(x, kMin) = x
constexpr unsigned kM4 = 0xFFFCFFFCu;   // -4 in both halves
constexpr unsigned kM16 = 0xFFF0FFF0u;  // -16: G of row -1 and column -1
constexpr unsigned kTop = 0xC000C000u;  // -16384: F above row 0
constexpr unsigned kZeroA = 0x0077u;    // selector bits: A reads code 7
constexpr unsigned kZeroB = 0x7700u;    // selector bits: B reads code 7

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
// (H << 16) | (0xFFFF - row mod 65,536), whose max holds the real-row max
// and its lowest row within a chunk of 65,536 rows; on phantom rows the
// packed max.
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

// One lane's share of a pair of windows: C consecutive columns of both.
template <int C>
struct Lane {
  unsigned sel[C], g[C], f[C];
  ColStats st[C];
  unsigned out_g = kM16, out_e = 0, prev_in_g = kM16;

  // the lane's columns of two windows with codes at rows ra and rb (-1: no
  // window, pad code 4), from column col0
  __device__ __forceinline__ void init(const uint8_t* __restrict__ codes,
                                       int stride, int ra, int rb,
                                       int col0) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const unsigned ca =
          ra >= 0 ? codes[(size_t)ra * stride + col0 + k] : 4;
      const unsigned cb =
          rb >= 0 ? codes[(size_t)rb * stride + col0 + k] : 4;
      sel[k] = selector(ca, cb);
      g[k] = kM16;
      f[k] = kTop;
    }
  }

  // query row i (table t) with the left column's G and E; zm (kZeroA,
  // kZeroB or 0) zeroes a half's scores, and a half that smask clears
  // keeps no statistics of the row
  template <bool kReal>
  __device__ __forceinline__ void row(int i, uint2 t, unsigned in_g,
                                      unsigned in_e, unsigned zm = 0,
                                      unsigned smask = kFull) {
    unsigned diag = prev_in_g;
    prev_in_g = in_g;
    unsigned gl = in_g, el = in_e;
    const unsigned tk = 0xFFFFu - static_cast<unsigned>(i);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const unsigned sc = prmt(t.x, t.y, sel[k] | zm);  // s + 16
      el = __viaddmax_s16x2(el, kM4, gl);                // E
      const unsigned tmp = __viaddmax_s16x2_relu(diag, sc, el);
      f[k] = __viaddmax_s16x2(f[k], kM4, g[k]);          // F
      const unsigned hv = __vimax_s16x2_relu(tmp, f[k]);  // H
      diag = g[k];
      gl = __viaddmax_s16x2(hv, kM16, kMin);             // H - 16
      g[k] = gl;
      if (kReal)
        st[k].real(hv & smask, tk);
      else
        st[k].phantom(hv & smask);
    }
    out_g = gl;
    out_e = el;
  }
};

// max / min over the L-lane segment of the calling lane
template <int L>
__device__ __forceinline__ int seg_max(int v) {
#pragma unroll
  for (int d = L / 2; d > 0; d /= 2)
    v = max(v, __shfl_xor_sync(kFull, v, d, L));
  return v;
}

template <int L>
__device__ __forceinline__ int seg_min(int v) {
#pragma unroll
  for (int d = L / 2; d > 0; d /= 2)
    v = min(v, __shfl_xor_sync(kFull, v, d, L));
  return v;
}

}  // namespace fasim_s16
