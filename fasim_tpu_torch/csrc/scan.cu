// K1 scan_colmax: per-column maxima of affine-gap Smith-Waterman for every
// (segment, transform) pair of a batch.
//
// Replaces fasim_tpu/kernels/tpu.py:_scan2_kernel (pallas_call in
// _kernel2_call, wrapped by _device_scan2).  Contract (ROADMAP.md
// "Semantics each kernel must keep"): exact int32 DP, gap open 16 /
// extend 4, the substitution score read from the make_qp2 rows
// (q, hi, lo, nval): s = code == q ? hi : lo, and for the threshold
// alphabet s = nval where the reference code is N (5).  Query rows
// m..m16-1 score 0 (phantom rows) and count toward the column max; rows
// at and beyond m16 do not exist here.  Outputs: the column maxima clamped
// to uint8 and the exact int32 maximum over all columns (the threshold).
//
// What bounds it on this card: int32 ALU throughput.  Every cell costs 13
// integer ops in the ssw alphabet (compare/select, three max-with-add
// chains, the column max; 14 in the threshold alphabet) and reads no
// memory: the segment codes sit in shared memory and the query profile in
// registers.  Design: one warp per pair, sweeping the segment columns as a
// diagonal wavefront over bands of query rows (sw_colmax.cuh, shared with
// K5), so the vertical gap is exact at any length (there is no 64-lane
// prefix window as on the TPU, and full_prefix changes nothing).  The
// pair's engine codes are decoded once into shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "sw_colmax.cuh"

namespace {

using fasim::kMaxRows;
using fasim::kWarp;
using fasim::QueryRow;

template <bool kThresh>
__global__ void __launch_bounds__(kWarp)
scan_colmax_kernel(const uint8_t* __restrict__ bases,
                   const uint8_t* __restrict__ bases_rev,
                   const int32_t* __restrict__ lut6, int lut_stride,
                   const int32_t* __restrict__ istr, int istr_stride,
                   const int32_t* __restrict__ qp, int qp_stride, int T,
                   int N, int m16, int32_t* __restrict__ bnd,
                   uint8_t* __restrict__ cm_out,
                   int32_t* __restrict__ gm_out) {
  extern __shared__ uint8_t codes[];
  __shared__ int32_t lut[6];
  const int pair = blockIdx.x;  // s * T + t
  const int s = pair / T;
  const int t = pair - s * T;
  const int lane = threadIdx.x;
  if (lane < 6) lut[lane] = lut6[t * lut_stride + lane];
  __syncwarp();
  // decode this pair's engine codes once: base class -> transform LUT,
  // reading the reversed segment for the reversed transforms
  const uint8_t* src =
      (istr[t * istr_stride] ? bases_rev : bases) + (size_t)s * N;
  for (int j = lane; j < N; j += kWarp) codes[j] = (uint8_t)lut[src[j]];
  __syncwarp();

  int gmax = 0;
  fasim::sweep_columns<fasim::CellI32<kThresh>>(
      codes, N, m16, bnd + (size_t)pair * 3 * N,
      [&](int row) {
        return QueryRow{qp[row], qp[qp_stride + row], qp[2 * qp_stride + row],
                        kThresh ? qp[3 * qp_stride + row] : 0};
      },
      [&](int j, int cm) {
        if (cm_out != nullptr)
          cm_out[(size_t)pair * N + j] = (uint8_t)min(cm, 255);
        gmax = max(gmax, cm);
      });
  if (lane == kWarp - 1) gm_out[pair] = gmax;
}

}  // namespace

extern "C" {

// Rows of one strip: the wrapper allocates the int32[S*T, 3, N] scratch
// row only for queries with m16 above it.
int fasim_scan_strip_rows() { return kWarp * kMaxRows; }

const char* fasim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bases / bases_rev uint8[S, N] (base classes 0..5); lut6 int32[T, >=6]
// and istr int32[T, >=1] with row strides; qp int32[>=4, qp_stride] query
// rows; bnd int32[S*T, 3, N] scratch (may be null for one strip); cm_out
// uint8[S, T, N] (null: thresholds only); gm_out int32[S, T].
int fasim_scan_colmax(const void* bases, const void* bases_rev,
                      const void* lut6, int lut_stride, const void* istr,
                      int istr_stride, const void* qp, int qp_stride, int S,
                      int T, int N, int m16, int thresh_alphabet, void* bnd,
                      void* cm_out, void* gm_out, void* stream) {
  if (S <= 0 || T <= 0 || N <= 0 || m16 <= 0) return 0;
  if (m16 > kWarp * kMaxRows && bnd == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(N);
  auto kern = thresh_alphabet ? scan_colmax_kernel<true>
                              : scan_colmax_kernel<false>;
  const cudaError_t err = fasim::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<S * T, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases),
      static_cast<const uint8_t*>(bases_rev),
      static_cast<const int32_t*>(lut6), lut_stride,
      static_cast<const int32_t*>(istr), istr_stride,
      static_cast<const int32_t*>(qp), qp_stride, T, N, m16,
      static_cast<int32_t*>(bnd), static_cast<uint8_t*>(cm_out),
      static_cast<int32_t*>(gm_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
