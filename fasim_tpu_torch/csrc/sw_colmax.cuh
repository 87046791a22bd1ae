// The DP core shared by K1 (scan.cu) and K5 (scan_codes.cu): one warp
// sweeps one code row against the query and hands every column's exact
// maximum to the caller.
//
// Exact int32 affine-gap Smith-Waterman, gap open 16 / extend 4.  Query
// row r scores s = code == q ? hi : lo, and in the threshold alphabet
// s = nv where the code is N (5); rows m..m16-1 are zero-profile (phantom
// rows, q = -1, hi = lo = nv = 0) and count toward the column max.
//
// Layout: lane k owns a band of up to kMaxRows consecutive query rows and
// the warp sweeps the columns as a diagonal wavefront (lane k works on
// column step - k).  The H and F of the row above a band and the running
// column max pass down the warp by shuffles, so the vertical gap is exact
// at any length.  Queries taller than one strip of 32 * kMaxRows rows run
// strip after strip; a strip's bottom row (H, F, column max) goes through
// a global scratch row read back by the next strip.  The bottom lane of
// the last strip owns the finished column max.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fasim {

constexpr int kGapOpen = 16;
constexpr int kGapExtend = 4;
constexpr int kWarp = 32;
constexpr int kMaxRows = 16;  // query rows per lane in one strip
constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

// One query row's scoring: s = code == q ? hi : lo (nv: the threshold
// alphabet's score of a reference N).
struct QueryRow {
  int q, hi, lo, nv;
};

// codes: the row's N codes (shared memory, written before the call and
// followed by a __syncwarp); load(row) -> QueryRow for rows < m16; bnd:
// int32[3, N] scratch (read only with more than one strip); emit(j, cm)
// runs on lane 31 for every column j in order.
template <bool kThresh, class Load, class Emit>
__device__ __forceinline__ void sweep_columns(const uint8_t* codes, int N,
                                              int m16, int32_t* bnd,
                                              Load load, Emit emit) {
  const int lane = threadIdx.x % kWarp;
  // spread the rows evenly over the strips so the last one is not mostly idle
  const int nstrips = (m16 + kWarp * kMaxRows - 1) / (kWarp * kMaxRows);
  const int rpt = (m16 + kWarp * nstrips - 1) / (kWarp * nstrips);
  int32_t* bh = bnd;  // used only with >1 strip
  int32_t* bf = bh + N;
  int32_t* bc = bf + N;
  for (int strip = 0; strip < nstrips; ++strip) {
    const int row0 = (strip * kWarp + lane) * rpt;
    const int nr = max(0, min(rpt, m16 - row0));
    int h[kMaxRows], e[kMaxRows], q[kMaxRows], hi[kMaxRows], lo[kMaxRows],
        nv[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const QueryRow qr = r < nr ? load(row0 + r) : QueryRow{-1, 0, 0, 0};
      h[r] = 0;
      e[r] = 0;
      q[r] = qr.q;
      hi[r] = qr.hi;
      lo[r] = qr.lo;
      nv[r] = kThresh ? qr.nv : 0;
    }
    const bool first = strip == 0;
    const bool last = strip == nstrips - 1;
    int up_prev = 0;  // H of the row above the band at the previous column
    int out_h = 0, out_f = kNeg, out_c = 0;
    for (int step = 0; step < N + kWarp - 1; ++step) {
      int in_h = __shfl_up_sync(kFull, out_h, 1);
      int in_f = __shfl_up_sync(kFull, out_f, 1);
      int in_c = __shfl_up_sync(kFull, out_c, 1);
      const int j = step - lane;
      if (j >= 0 && j < N) {
        if (lane == 0) {
          if (first) {
            in_h = 0;
            in_f = kNeg;
            in_c = 0;
          } else {
            in_h = bh[j];
            in_f = bf[j];
            in_c = bc[j];
          }
        }
        const int c = codes[j];
        int diag = up_prev;
        up_prev = in_h;
        int hu = in_h, f = in_f, cm = in_c;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nr) {
            int sc = c == q[r] ? hi[r] : lo[r];
            if (kThresh && c == 5) sc = nv[r];
            const int ev = max(e[r] - kGapExtend, h[r] - kGapOpen);
            const int tmp = max(max(diag + sc, ev), 0);
            f = max(hu - kGapOpen, f - kGapExtend);
            const int hv = max(tmp, f);
            diag = h[r];
            h[r] = hv;
            e[r] = ev;
            hu = hv;
            cm = max(cm, hv);
          }
        }
        out_h = hu;
        out_f = f;
        out_c = cm;
        if (lane == kWarp - 1) {
          if (last) {
            emit(j, cm);
          } else {
            bh[j] = hu;
            bf[j] = f;
            bc[j] = cm;
          }
        }
      }
      // orders the scratch-row writes of one strip before the next strip's
      // reads (the same warp, other lanes)
      __syncwarp();
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace fasim
