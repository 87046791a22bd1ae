// K1 scan_colmax: per-column maxima of affine-gap Smith-Waterman for every
// (segment, transform) pair of a batch.
//
// Replaces fasim_tpu/kernels/tpu.py:_scan2_kernel (pallas_call in
// _kernel2_call, wrapped by _device_scan2).  Contract (ROADMAP.md
// "Semantics each kernel must keep"): exact int32 DP, gap open 16 /
// extend 4, the substitution score of the make_qp2 rows (q, hi, lo,
// nval): s = code == q ? hi : lo, and for the threshold alphabet s = nval
// where the reference code is N (5), read here through the rows' score
// classes (scan.py:scan_table).  Query rows m..m16-1 score 0 (phantom
// rows) and count toward the column max.  Outputs: the column maxima
// clamped to uint8 and the exact int32 maximum over all columns (the
// threshold).
//
// What bounds it on this card: integer throughput.  The pass reads no memory
// beyond the segment bases and writes only the outputs, so the cells'
// operations set its time: 7 a cell at the least in int32 (the DPX forms;
// chip_smoke.ops_per_cell), against the 13 (ssw) and 14 (threshold alphabet)
// of the compare/select cell this kernel had before, whose rows each also
// paid a guard branch.  Design: one warp per pair, sweeping the segment
// columns as a diagonal wavefront over bands of query rows (sw_colmax.cuh),
// so the vertical gap is exact at any length (there is no 64-lane prefix
// window as on the TPU, and full_prefix changes nothing), on the DPX cell
// sw_colmax.cuh:CellI32Dpx.  The rows fall into at most 8 score classes,
// whose 8 x 8-byte table of scores + 16 (scan.py:scan_table) sits in shared
// memory; a column reads its code and its 8 bytes once, and each row scores
// by one prmt of its class's selector.  Both alphabets run the same kernel:
// the table holds the threshold alphabet's N scores.  The rows per lane are a
// template argument (sweep_rows(m16), 1..16) and the rows the strips hold
// beyond the m16 query rows sit above row 0 as zero-score rows, so the row
// loop has no guard; the strip hand-off moves 32 columns at a time through
// shared memory, so no step branches on the lane (sweep_columns_fixed).  A
// row keeps 3 registers (G, E, selector), so the kernel fits the launch
// bound of 24 one-warp blocks an SM: a 64-segment batch (3,072 pairs) is one
// wave on 132 SMs.  The pair's engine codes are decoded once into shared
// memory.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "sw_colmax.cuh"

namespace {

using fasim::kMaxRows;
using fasim::kWarp;

// 24 one-warp blocks an SM (3,168 on 132 SMs, one wave of a 64-segment
// batch): ptxas keeps to 80 registers, with no spill at 16 rows a lane
constexpr int kMinBlocks = 24;
constexpr int kClasses = 8;

template <int kRows>
__global__ void __launch_bounds__(kWarp, kMinBlocks)
scan_colmax_kernel(const uint8_t* __restrict__ bases,
                   const uint8_t* __restrict__ bases_rev,
                   const int32_t* __restrict__ lut6, int lut_stride,
                   const int32_t* __restrict__ istr, int istr_stride,
                   const uint8_t* __restrict__ tab, int T, int N, int m16,
                   int32_t* __restrict__ bnd, uint8_t* __restrict__ cm_out,
                   int32_t* __restrict__ gm_out) {
  using Cell = fasim::CellI32Dpx;
  extern __shared__ uint8_t codes[];
  __shared__ int32_t lut[6];
  __shared__ uint2 stab[kClasses];  // per code: the classes' scores + 16
  const int pair = blockIdx.x;  // s * T + t
  const int s = pair / T;
  const int t = pair - s * T;
  const int lane = threadIdx.x;
  if (lane < 6) lut[lane] = lut6[t * lut_stride + lane];
  for (int i = lane; i < kClasses * 8; i += kWarp)
    reinterpret_cast<uint8_t*>(stab)[i] = tab[i];
  __syncwarp();
  // decode this pair's engine codes once: base class -> transform LUT,
  // reading the reversed segment for the reversed transforms
  const uint8_t* src =
      (istr[t * istr_stride] ? bases_rev : bases) + (size_t)s * N;
  for (int j = lane; j < N; j += kWarp) codes[j] = (uint8_t)lut[src[j]];
  __syncwarp();

  const uint8_t* cls = tab + kClasses * 8;  // the class of each query row
  int gmax = 0;
  fasim::sweep_columns_fixed<Cell, kRows>(
      [&](int j) { return stab[codes[j] & (kClasses - 1)]; }, N, m16,
      bnd + (size_t)pair * 3 * N, [&](int row) { return (int)cls[row]; },
      [&](int j, int cm) {
        if (cm_out != nullptr)
          cm_out[(size_t)pair * N + j] = (uint8_t)min(cm, 255);
        gmax = max(gmax, cm);
      });
  // each lane saw the columns j with j % 32 == lane
  for (int d = kWarp / 2; d > 0; d /= 2)
    gmax = max(gmax, __shfl_xor_sync(fasim::kFull, gmax, d));
  if (lane == 0) gm_out[pair] = gmax;
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, const int32_t*, int,
                        const int32_t*, int, const uint8_t*, int, int, int,
                        int32_t*, uint8_t*, int32_t*);

// the instantiation for `rows` rows a lane (1..kMaxRows)
template <int... R>
Kernel pick(int rows, std::integer_sequence<int, R...>) {
  Kernel k = nullptr;
  ((rows == R + 1 ? (k = scan_colmax_kernel<R + 1>, 0) : 0), ...);
  return k;
}

Kernel kernel_for(int m16) {
  return pick(fasim::sweep_rows(m16),
              std::make_integer_sequence<int, kMaxRows>{});
}

}  // namespace

extern "C" {

// Rows of one strip: the wrapper allocates the int32[S*T, 3, N] scratch
// row only for queries with m16 above it.
int fasim_scan_strip_rows() { return kWarp * kMaxRows; }

// Rows a lane of the kernel launched for query length m16: the template
// argument kernel_for picks (chip_smoke.py counts that instantiation's SASS).
int fasim_scan_rows(int m16) { return fasim::sweep_rows(m16); }

const char* fasim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Resident one-warp blocks an SM of the kernel for query length m16 with N
// segment columns (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a
// negative CUDA error code.
int fasim_scan_blocks_per_sm(int m16, int N) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_for(m16), kWarp, static_cast<size_t>(N));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// bases / bases_rev uint8[S, N] (base classes 0..5); lut6 int32[T, >=6]
// and istr int32[T, >=1] with row strides (engine codes 0..7); tab
// uint8[64 + >=m16]: the score table (byte 8 * code + class: the class's
// score + 16) and then the class of each query row (scan.py:scan_table);
// bnd int32[S*T, 3, N] scratch (may be null for one strip); cm_out
// uint8[S, T, N] (null: thresholds only); gm_out int32[S, T].
int fasim_scan_colmax(const void* bases, const void* bases_rev,
                      const void* lut6, int lut_stride, const void* istr,
                      int istr_stride, const void* tab, int S, int T, int N,
                      int m16, void* bnd, void* cm_out, void* gm_out,
                      void* stream) {
  if (S <= 0 || T <= 0 || N <= 0 || m16 <= 0) return 0;
  if (m16 > kWarp * kMaxRows && bnd == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(N);
  const Kernel kern = kernel_for(m16);
  const cudaError_t err = fasim::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<S * T, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases),
      static_cast<const uint8_t*>(bases_rev),
      static_cast<const int32_t*>(lut6), lut_stride,
      static_cast<const int32_t*>(istr), istr_stride,
      static_cast<const uint8_t*>(tab), T, N, m16,
      static_cast<int32_t*>(bnd), static_cast<uint8_t*>(cm_out),
      static_cast<int32_t*>(gm_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
