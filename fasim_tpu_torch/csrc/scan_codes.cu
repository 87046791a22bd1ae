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
// What bounds it on this card: with many code rows (a packed batch: 64
// segments x 48 transforms = 3,072 rows), K1's bound: integer throughput,
// 7 operations a cell on the DPX forms, no memory traffic beyond one read
// of the code row and one write of the int32 column maxima.  With few
// (the per-segment path: one segment, 48 rows) no design fills the card:
// a row's cells form one chain of dependent steps, each strip of it a
// wavefront of N + 31 steps, and 48 rows hold at most 48 of the 132 SMs.
// There the time is the latency of a step (a lane's rows one after
// another, then the shuffles to the next lane) times the steps of the
// longest warp, and the design shortens both.
//
// Design: K1's cell and sweep (sw_colmax.cuh:CellI32Dpx,
// sweep_columns_fixed), on the score-class table of scan_codes.py:
// scan_codes_table: the code row is copied once into shared memory, U
// folded to T in the threshold alphabet and any code >= 8 to the
// alphabet's pad code, so a column's 8-byte table word is stab[code].  The
// cell takes its short form (CellI32DpxT<true>: one dependent operation a
// row down a lane's rows in place of three).  The launch plan
// (fasim_scan_codes_plan) picks the warps of a code row's block from the
// number of code rows and m16, at K1's sweep_rows(m16) rows a lane: many
// rows run K1's one warp a row, one wave of 24 one-warp blocks an SM; few
// rows run a pipelined block, a warp for each strip of the row (up to 16
// warps; past that the strips wrap through the global scratch row), so the
// strips run at once, each two 32-column blocks behind the one above, and
// the column word is fetched a step ahead.  One segment's 48 rows at MEG3
// length run 4 warps a row, one on each scheduler of 48 SMs.  A step's
// time is mostly a fixed part and little a row a lane (chip_smoke.py's K5
// step probe; PERF.md has an H100's numbers), so fewer rows a lane on more
// warps do not pay: the warps then share the schedulers.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <utility>

#include "sw_colmax.cuh"

namespace {

using fasim::kMaxRows;
using fasim::kMaxWarps;
using fasim::kWarp;

// one-warp blocks: K1's launch bound, 24 an SM
constexpr int kMinBlocks = 24;
constexpr int kClasses = 8;
// resident warps an SM the plan aims a launch of few code rows at
constexpr int kTargetWarps = 8;

template <int kRows, bool kPipe>
__global__ void __launch_bounds__(kPipe ? kMaxWarps * kWarp : kWarp,
                                  kPipe ? 1 : kMinBlocks)
scan_codes_kernel(const uint8_t* __restrict__ codes_in, int N,
                  const uint8_t* __restrict__ tab, int m16, int thresh,
                  int pad_code, int32_t* __restrict__ bnd,
                  int32_t* __restrict__ out) {
  using Cell = fasim::CellI32DpxT<true>;  // the short F chain
  extern __shared__ uint8_t codes[];
  __shared__ uint2 stab[kClasses];  // per code: the classes' scores + 16
  const int row = blockIdx.x;
  for (int i = threadIdx.x; i < kClasses * 8; i += blockDim.x)
    reinterpret_cast<uint8_t*>(stab)[i] = tab[i];
  const uint8_t* src = codes_in + (size_t)row * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const int c = src[j];
    // U scores exactly like T; every code >= 8 like the pad code
    codes[j] =
        (uint8_t)(c >= kClasses ? pad_code : thresh && c == 4 ? 3 : c);
  }
  if (kPipe)
    __syncthreads();
  else
    __syncwarp();
  const uint8_t* cls = tab + kClasses * 8;  // the class of each query row
  int32_t* dst = out + (size_t)row * N;
  fasim::sweep_columns_fixed<Cell, kRows, kPipe>(
      [&](int j) { return stab[codes[j]]; }, N, m16,
      bnd + (size_t)row * 3 * N, [&](int r) { return (int)cls[r]; },
      [&](int j, int cm) { dst[j] = cm; });
}

using Kernel = void (*)(const uint8_t*, int, const uint8_t*, int, int, int,
                        int32_t*, int32_t*);

// the instantiation for `rows` rows a lane (1..kMaxRows)
template <bool kPipe, int... R>
Kernel pick(int rows, std::integer_sequence<int, R...>) {
  Kernel k = nullptr;
  ((rows == R + 1 ? (k = scan_codes_kernel<R + 1, kPipe>, 0) : 0), ...);
  return k;
}

Kernel kernel_for(int rows, int warps) {
  constexpr auto all = std::make_integer_sequence<int, kMaxRows>{};
  return warps == 1 ? pick<false>(rows, all) : pick<true>(rows, all);
}

bool valid_plan(int rows, int warps) {
  return rows >= 1 && rows <= kMaxRows && warps >= 1 && warps <= kMaxWarps;
}

}  // namespace

extern "C" {

// The launch plan for `rows` code rows at query length m16 on the current
// device: out[0] rows a lane, sweep_rows(m16) as in K1, and out[1] warps a
// code row's block: one when the rows alone give every SM kTargetWarps
// warps, else a warp a strip, as many as that target leaves each row (at
// most kMaxWarps).  Returns a CUDA error code.
int fasim_scan_codes_plan(int rows, int m16, int* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_row = (sms * kTargetWarps + rows - 1) / std::max(rows, 1);
  out[0] = fasim::sweep_rows(m16);
  out[1] = std::max(1, std::min({fasim::sweep_strips(m16), per_row,
                                 kMaxWarps}));
  return 0;
}

// 1 when a launch of `rows` rows a lane and `warps` warps at query length
// m16 needs the scratch row (more strips than warps), else 0.
int fasim_scan_codes_scratch(int m16, int rows, int warps) {
  return fasim::sweep_strips(m16, rows) > warps ? 1 : 0;
}

// Resident blocks an SM of that launch with N columns (the CUDA occupancy
// calculator), or a negative CUDA error code.
int fasim_scan_codes_blocks_per_sm(int rows, int warps, int N) {
  if (!valid_plan(rows, warps))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_for(rows, warps), warps * kWarp,
      static_cast<size_t>(N));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// codes uint8[n_rows, N] engine codes; tab uint8[64 + >= m16]: the score
// table (byte 8 * code + class: the class's score + 16) and then the class
// of each query row (scan_codes.py:scan_codes_table); thresh 1 for the
// threshold alphabet; pad_code the alphabet's pad code (< 8); rows, warps
// the plan (fasim_scan_codes_plan or any other within 1..16 each); bnd
// int32[n_rows, 3, N] scratch (may be null when fasim_scan_codes_scratch
// is 0); out int32[n_rows, N].
int fasim_scan_codes_colmax(const void* codes, int n_rows, int N,
                            const void* tab, int m16, int thresh,
                            int pad_code, int rows, int warps, void* bnd,
                            void* out, void* stream) {
  if (n_rows <= 0 || N <= 0 || m16 <= 0) return 0;
  if (!valid_plan(rows, warps) || pad_code < 0 || pad_code >= kClasses ||
      (fasim_scan_codes_scratch(m16, rows, warps) && bnd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(N);
  const Kernel kern = kernel_for(rows, warps);
  const cudaError_t err = fasim::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<n_rows, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), N, static_cast<const uint8_t*>(tab),
      m16, thresh, pad_code, static_cast<int32_t*>(bnd),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
