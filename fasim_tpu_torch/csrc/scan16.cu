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
// What bounds it on this card: integer throughput, 7 s16x2 operations per
// two cells (sw_colmax.cuh:CellS16x2T), half the 7 int32 operations a cell
// of K1, and no memory traffic beyond the segment bases and the outputs.
// Design: K1's sweep (sw_colmax.cuh:sweep_columns_fixed: the rows a lane a
// template argument, sweep_rows(m16) in 1..16, zero-score rows above row
// 0, the strip hand-off 32 columns at a time through shared memory) with
// the 16-bit cell in G = H - 16 form.  The pair's two code rows become one
// row of prmt selectors in shared memory (2 bytes a column), and each
// query row keeps its 8-byte table of scores + 16 (scan.py:scan16_table,
// built once per alphabet on the host side), so one prmt scores both
// halves in either alphabet.  Below 16 rows a lane the cell takes the
// short F chain (one dependent operation a row down a lane's rows,
// CellS16x2T<true>), at 16 the long one: on an H100 the short form was
// about 1% faster at 13 rows a lane (the MEG3 pass) and the long one
// about 2% faster at 16 (NEAT1 length; PERF.md §6).  Every
// lane emits the columns j with j % 32 == lane, so the per-pair maximum is
// a warp-wide reduction at the end.  Queries over 512 rows run in strips
// through a global scratch row of packed words (3 * N words per warp).
// The selector row is 2 bytes a column, so -c 50000 needs about 100 KB of
// shared memory (allow_smem).
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "sw_colmax.cuh"

namespace {

using fasim::kMaxRows;
using fasim::kWarp;

// 12 one-warp blocks an SM (1,584 on 132 SMs: a 64-segment batch's 1,536
// warps in one wave); ptxas may take up to 168 registers, and spills none
// at 16 rows a lane
constexpr int kMinBlocks = 12;

template <int kRows>
__global__ void __launch_bounds__(kWarp, kMinBlocks)
scan16_kernel(const uint8_t* __restrict__ bases,
              const uint8_t* __restrict__ bases_rev,
              const int32_t* __restrict__ lut6, int lut_stride,
              const int32_t* __restrict__ istr, int istr_stride,
              const uint2* __restrict__ tab, int T, int N, int m16,
              unsigned* __restrict__ bnd, uint8_t* __restrict__ cm_out,
              int32_t* __restrict__ gm_out) {
  using Cell = fasim::CellS16x2T<(kRows < kMaxRows)>;
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
    sel[j] = (uint16_t)Cell::selector(lut[0][src_a[j]], lut[1][src_b[j]]);
  __syncwarp();

  const size_t out_a = (size_t)s * T + ta;  // pair (s, 2k); (s, 2k + 1) next
  unsigned gmax = 0;
  fasim::sweep_columns_fixed<Cell, kRows>(
      [&](int j) { return (unsigned)sel[j]; }, N, m16,
      bnd + (size_t)warp * 3 * N, [&](int row) { return tab[row]; },
      [&](int j, unsigned cm) {
        // both halves are >= 0: plain shifts unpack them
        if (cm_out != nullptr) {
          cm_out[out_a * N + j] = (uint8_t)min(cm & 0xffffu, 255u);
          cm_out[(out_a + 1) * N + j] = (uint8_t)min(cm >> 16, 255u);
        }
        gmax = __vimax_s16x2_relu(gmax, cm);
      });
  // each lane saw the columns j with j % 32 == lane
  for (int d = kWarp / 2; d > 0; d /= 2)
    gmax = __vimax_s16x2_relu(gmax, __shfl_xor_sync(fasim::kFull, gmax, d));
  if (lane == 0) {
    gm_out[out_a] = (int32_t)(gmax & 0xffffu);
    gm_out[out_a + 1] = (int32_t)(gmax >> 16);
  }
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, const int32_t*, int,
                        const int32_t*, int, const uint2*, int, int, int,
                        unsigned*, uint8_t*, int32_t*);

// the instantiation for `rows` rows a lane (1..kMaxRows)
template <int... R>
Kernel pick(int rows, std::integer_sequence<int, R...>) {
  Kernel k = nullptr;
  ((rows == R + 1 ? (k = scan16_kernel<R + 1>, 0) : 0), ...);
  return k;
}

Kernel kernel_for(int m16) {
  return pick(fasim::sweep_rows(m16),
              std::make_integer_sequence<int, kMaxRows>{});
}

size_t smem_for(int N) { return static_cast<size_t>(N) * sizeof(uint16_t); }

}  // namespace

extern "C" {

// Resident one-warp blocks an SM of K7's kernel for query length m16 with
// N segment columns (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a
// negative CUDA error code.
int fasim_scan16_blocks_per_sm(int m16, int N) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_for(m16), kWarp, smem_for(N));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// As fasim_scan_colmax (scan.cu) for T even and 5 * min(m16, N) <= 30000,
// with tab uint8[>= m16, 8] (8-byte aligned): each query row's score + 16
// for the engine codes 0..7 (scan.py:scan16_table); bnd int32[S * T / 2,
// 3, N] scratch (may be null for one strip).
int fasim_scan_colmax16(const void* bases, const void* bases_rev,
                        const void* lut6, int lut_stride, const void* istr,
                        int istr_stride, const void* tab, int S, int T, int N,
                        int m16, void* bnd, void* cm_out, void* gm_out,
                        void* stream) {
  if (S <= 0 || T <= 0 || N <= 0 || m16 <= 0) return 0;
  if (T % 2 != 0 || 5LL * (m16 < N ? m16 : N) > 30000)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m16 > kWarp * kMaxRows && bnd == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_for(N);
  const Kernel kern = kernel_for(m16);
  const cudaError_t err = fasim::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<S * (T / 2), kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases),
      static_cast<const uint8_t*>(bases_rev),
      static_cast<const int32_t*>(lut6), lut_stride,
      static_cast<const int32_t*>(istr), istr_stride,
      static_cast<const uint2*>(tab), T, N, m16, static_cast<unsigned*>(bnd),
      static_cast<uint8_t*>(cm_out), static_cast<int32_t*>(gm_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
