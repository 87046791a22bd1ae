// K7 scan_colmax16: K1's per-column maxima and per-pair maxima with the DP
// in 16 bits, two (segment, transform) pairs per warp.
//
// Replaces the int16 path of fasim_tpu/kernels/tpu.py:_scan2_kernel
// (_dp_col2's int16 branch, pallas_call in _kernel2_call with use16,
// switched on by FASIM_SCAN16=1).  Contract: K1's (scan.cu), for batches
// inside the caller's gate: an even transform count T and
// 5 * min(m16, N) <= 30000, so that every H fits in int16.  The
// transforms 2k and 2k + 1 of one segment share a warp: the low half of
// each register holds the first one's cell, the high half the second's;
// each half reads bases or bases_rev by its own istr.  Outputs: the column
// maxima clamped to uint8 and the exact maximum over all columns.
//
// What bounds it on this card: integer ALU throughput, 7 s16x2 operations
// per two cells (sw_colmax.cuh:CellS16x2), against the 7 int32 operations
// per cell of K1's DPX cell (CellI32Dpx), and no memory traffic beyond the
// segment bases and the outputs.  Design: K1's wavefront over bands of query rows
// (sw_colmax.cuh), with the cell policy swapped: the pair's two code rows
// become one row of prmt selectors in shared memory (2 bytes a column),
// and each query row keeps an 8-entry int8 score table instead of its
// q / hi / lo / nv.  Queries over 512 rows run in strips through a global
// scratch row of packed words (3 * N words per warp).
#include <cuda_runtime.h>

#include <cstdint>

#include "sw_colmax.cuh"

namespace {

using fasim::kMaxRows;
using fasim::kWarp;
using fasim::QueryRow;

template <bool kThresh>
__global__ void __launch_bounds__(kWarp)
scan16_kernel(const uint8_t* __restrict__ bases,
              const uint8_t* __restrict__ bases_rev,
              const int32_t* __restrict__ lut6, int lut_stride,
              const int32_t* __restrict__ istr, int istr_stride,
              const int32_t* __restrict__ qp, int qp_stride, int T, int N,
              int m16, unsigned* __restrict__ bnd,
              uint8_t* __restrict__ cm_out, int32_t* __restrict__ gm_out) {
  using Cell = fasim::CellS16x2<kThresh>;
  extern __shared__ uint16_t sel[];
  __shared__ int32_t lut[2][6];
  const int warp = blockIdx.x;  // s * (T / 2) + k: pairs (s, 2k), (s, 2k + 1)
  const int half_t = T / 2;
  const int s = warp / half_t;
  const int ta = 2 * (warp - s * half_t);
  const int lane = threadIdx.x;
  if (lane < 12) {
    const int h = lane / 6, b = lane % 6;
    lut[h][b] = lut6[(ta + h) * lut_stride + b];
  }
  __syncwarp();
  const uint8_t* src_a =
      (istr[ta * istr_stride] ? bases_rev : bases) + (size_t)s * N;
  const uint8_t* src_b =
      (istr[(ta + 1) * istr_stride] ? bases_rev : bases) + (size_t)s * N;
  for (int j = lane; j < N; j += kWarp)
    sel[j] = Cell::selector(lut[0][src_a[j]], lut[1][src_b[j]]);
  __syncwarp();

  uint8_t* cm_a = cm_out + ((size_t)s * T + ta) * N;
  unsigned gmax = 0;
  fasim::sweep_columns<Cell>(
      sel, N, m16, bnd + (size_t)warp * 3 * N,
      [&](int row) {
        return QueryRow{qp[row], qp[qp_stride + row], qp[2 * qp_stride + row],
                        kThresh ? qp[3 * qp_stride + row] : 0};
      },
      [&](int j, unsigned cm) {
        // both halves are >= 0: plain shifts unpack them
        if (cm_out != nullptr) {
          cm_a[j] = (uint8_t)min(cm & 0xffffu, 255u);
          cm_a[N + j] = (uint8_t)min(cm >> 16, 255u);
        }
        gmax = __vimax_s16x2_relu(gmax, cm);
      });
  if (lane == kWarp - 1) {
    gm_out[(size_t)s * T + ta] = (int32_t)(gmax & 0xffffu);
    gm_out[(size_t)s * T + ta + 1] = (int32_t)(gmax >> 16);
  }
}

}  // namespace

extern "C" {

// As fasim_scan_colmax (scan.cu) for T even and 5 * min(m16, N) <= 30000;
// bnd int32[S * T / 2, 3, N] scratch (may be null for one strip).
int fasim_scan_colmax16(const void* bases, const void* bases_rev,
                        const void* lut6, int lut_stride, const void* istr,
                        int istr_stride, const void* qp, int qp_stride, int S,
                        int T, int N, int m16, int thresh_alphabet, void* bnd,
                        void* cm_out, void* gm_out, void* stream) {
  if (S <= 0 || T <= 0 || N <= 0 || m16 <= 0) return 0;
  if (T % 2 != 0 || 5LL * (m16 < N ? m16 : N) > 30000)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m16 > kWarp * kMaxRows && bnd == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(N) * sizeof(uint16_t);
  auto kern = thresh_alphabet ? scan16_kernel<true> : scan16_kernel<false>;
  const cudaError_t err = fasim::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<S * (T / 2), kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases),
      static_cast<const uint8_t*>(bases_rev),
      static_cast<const int32_t*>(lut6), lut_stride,
      static_cast<const int32_t*>(istr), istr_stride,
      static_cast<const int32_t*>(qp), qp_stride, T, N, m16,
      static_cast<unsigned*>(bnd), static_cast<uint8_t*>(cm_out),
      static_cast<int32_t*>(gm_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
