// K5 scan_codes_colmax: exact int32 per-column maxima of affine-gap
// Smith-Waterman for prebuilt code rows (the v1 scan).
//
// Replaces fasim_tpu/kernels/tpu.py:_scan_kernel (pallas_call in
// _kernel_call; callers TpuScanEngine.colmax_batch / max_batch / __call__
// and _device_scan).  Contract: codes are engine codes (ssw A0 C1 G2 T3
// N4; thresh A0 C1 G2 T3 U4 N5; anything else a pad code that scores like
// a mismatch), the query comes as the make_qprops rows (q, maska, qn,
// valid), and the score is _score_col's: ssw 5 where code == q and maska,
// else -4; thresh -1 where qn or the code is N, 5 where code == q or (maska
// and the code is T or U), else -4; 0 on rows that are not valid (past m).
// Rows m..m16-1 (phantom rows) count toward the column max.  Gap open 16,
// extend 4.  The output is the exact int32 column max, unclamped (callers
// read values >= 251), for every column: the vertical gap is exact at any
// length, so there is no windowed prefix (fwin) and no escalation rerun.
//
// What bounds it on this card: int32 ALU throughput, 13 integer ops per
// cell in the ssw alphabet and 14 in the threshold alphabet (the
// compare/select cell sw_colmax.cuh:CellI32, which K1 left for its DPX
// cell; K5 is still on it), and no memory traffic beyond one read of the
// code row and one write of the int32 column maxima.  Design: K1's
// decomposition (sw_colmax.cuh): one warp per code row, lanes owning
// bands of up to 16 query rows, the warp sweeping
// the columns as a diagonal wavefront with exact F; queries taller than
// 512 rows run in strips through a global scratch row.  The code row is
// read once into shared memory; in the threshold alphabet T and U are
// folded into one code there (and maska rows match it), which gives
// _score_col's scores with CellI32's compare/select.  With few rows (the
// per-segment path: one segment, 48 rows) only 48 warps run on 132 SMs.
#include <cuda_runtime.h>

#include <cstdint>

#include "sw_colmax.cuh"

namespace {

using fasim::kMaxRows;
using fasim::kWarp;
using fasim::QueryRow;

template <bool kThresh>
__global__ void __launch_bounds__(kWarp)
scan_codes_kernel(const uint8_t* __restrict__ codes_in, int N,
                  const int32_t* __restrict__ qprops, int qp_stride, int m16,
                  int32_t* __restrict__ bnd, int32_t* __restrict__ out) {
  extern __shared__ uint8_t codes[];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* src = codes_in + (size_t)row * N;
  for (int j = lane; j < N; j += kWarp) {
    const uint8_t c = src[j];
    codes[j] = (kThresh && c == 4) ? 3 : c;  // U scores exactly like T
  }
  __syncwarp();
  int32_t* dst = out + (size_t)row * N;
  fasim::sweep_columns<fasim::CellI32<kThresh>>(
      codes, N, m16, bnd + (size_t)row * 3 * N,
      [&](int r) {
        const int q = qprops[r];
        const bool maska = qprops[qp_stride + r] != 0;
        const bool qn = qprops[2 * qp_stride + r] != 0;
        if (qprops[3 * qp_stride + r] == 0) return QueryRow{-1, 0, 0, 0};
        if (kThresh)
          return QueryRow{maska ? 3 : q, qn ? -1 : 5, qn ? -1 : -4, -1};
        return QueryRow{q, maska ? 5 : -4, -4, 0};
      },
      [&](int j, int cm) { dst[j] = cm; });
}

}  // namespace

extern "C" {

// codes uint8[rows, N] engine codes; qprops int32[4, qp_stride] (q,
// maska, qn, valid) with qp_stride >= m16; bnd int32[rows, 3, N] scratch
// (may be null when m16 <= fasim_scan_strip_rows()); out int32[rows, N].
int fasim_scan_codes_colmax(const void* codes, int rows, int N,
                            const void* qprops, int qp_stride, int m16,
                            int thresh_alphabet, void* bnd, void* out,
                            void* stream) {
  if (rows <= 0 || N <= 0 || m16 <= 0) return 0;
  if (m16 > kWarp * kMaxRows && bnd == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(N);
  auto kern = thresh_alphabet ? scan_codes_kernel<true>
                              : scan_codes_kernel<false>;
  const cudaError_t err = fasim::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<rows, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), N,
      static_cast<const int32_t*>(qprops), qp_stride, m16,
      static_cast<int32_t*>(bnd), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
