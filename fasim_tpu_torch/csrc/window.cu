// K4 window_general in int32 cells: the batched candidate-window pass with
// per-row offsets, phantom bounds and terminate scores, returning the
// scan-order ends (best, end_col, end_row) of one affine-gap Smith-Waterman
// pass of the query against one window row, at any query length.  K4's
// main kernel is window_gen.cu (16-bit cells and row keys); the wrapper
// (kernels/window.py:window_general) routes queries longer than 65,536
// rows here by shape.
//
// Replaces fasim_tpu/kernels/tpu.py:_wscan_kernel (pallas_call in
// _wscan_call, ends in _ends_from_stats) for those queries.  Contract
// (kernels/xla.py:window_pass_xla): s = hi if code == q else lo on query
// rows off <= i < m, 0 elsewhere (zero-profile prefix and phantom rows);
// the column max runs over rows < mreal; end_row is the
// lowest row in [off, m) attaining the max of the end column; end_col is
// the first column < rlen attaining the best; under terms >= 0 the columns
// after the first one whose max equals terms are cut off (sswNew.cpp:617);
// a best <= 0 gives (0, -1, m - 1).
//
// What bounds it on this card: int32 ALU throughput, ~19 ops per cell and no
// memory traffic beyond the window codes and the query row (L1 hits).
// Design: one warp per window row, lane k owning C = Wp / 32 consecutive
// window columns; the warp sweeps the query rows as a diagonal wavefront
// (lane k works on row step - k).  The horizontal gap state (H and E of
// the column left of a lane's block) passes right by shuffles; the
// vertical gap F and the per-column statistics stay in the lane's
// registers, so the column max and its lowest row need no cross-lane
// reduction until the end, where one warp reduction applies the ends
// rules above.  There are no width-dependent prefix windows or phases: F
// is exact at every width up to 256, including rlens in (196, 256].
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGapOpen = 16;
constexpr int kGapExtend = 4;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kNeg = -(1 << 30);
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
window_ends_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ qp, int qp_stride,
                   const int32_t* __restrict__ offs,
                   const int32_t* __restrict__ mreals,
                   const int32_t* __restrict__ terms,
                   const int32_t* __restrict__ rlens, int rows, int m,
                   int32_t* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // whole warps leave together
  const int off = offs[row];
  const int mreal = mreals[row];
  const int term = terms[row];
  const int rlen = rlens[row];
  // rows past the query's row count (the engine keeps mreal <= m + 15
  // within it) would read past the rows; bound the sweep there
  const int nrows = min(max(mreal, m), qp_stride);
  const int col0 = lane * C;
  int code[C], hup[C], f[C], cmax[C], rmax[C], rrow[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    code[k] = codes[(size_t)row * (kWarp * C) + col0 + k];
    hup[k] = 0;  // H of the previous query row
    f[k] = kNeg;
    cmax[k] = 0;
    rmax[k] = -1;
    rrow[k] = kBig;
  }
  int out_h = 0, out_e = 0, prev_in_h = 0;
  for (int step = 0; step < nrows + kWarp - 1; ++step) {
    int in_h = __shfl_up_sync(kFull, out_h, 1);
    int in_e = __shfl_up_sync(kFull, out_e, 1);
    const int i = step - lane;
    if (i >= 0 && i < nrows) {
      if (lane == 0) {  // column -1: H = E = 0
        in_h = 0;
        in_e = 0;
      }
      const int qi = qp[i];
      const int hi = qp[qp_stride + i];
      const int lo = qp[2 * qp_stride + i];
      const bool live = i >= off;
      const bool stat_c = i < mreal;
      const bool stat_r = live && stat_c && i < m;
      int diag = prev_in_h;
      prev_in_h = in_h;
      int hl = in_h, el = in_e;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int sc = live ? (code[k] == qi ? hi : lo) : 0;
        const int ev = max(el - kGapExtend, hl - kGapOpen);
        const int fv = max(hup[k] - kGapOpen, f[k] - kGapExtend);
        const int hv = max(max(diag + sc, ev), max(fv, 0));
        diag = hup[k];
        hup[k] = hv;
        f[k] = fv;
        hl = hv;
        el = ev;
        if (stat_c) cmax[k] = max(cmax[k], hv);
        if (stat_r && hv > rmax[k]) {
          rmax[k] = hv;
          rrow[k] = i;
        }
      }
      out_h = hl;
      out_e = el;
    }
  }

  // per-column (max, lowest real row) -> scan-order ends
  int first_eq = kBig;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = col0 + k;
    if (c < rlen && term >= 0 && cmax[k] == term) first_eq = min(first_eq, c);
  }
  const int limit = __reduce_min_sync(kFull, first_eq);
  int best = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = col0 + k;
    if (c < rlen && c <= limit) best = max(best, cmax[k]);
  }
  best = __reduce_max_sync(kFull, best);
  int ecol = kBig, erow = kBig;
#pragma unroll
  for (int k = C - 1; k >= 0; --k) {
    const int c = col0 + k;
    if (c < rlen && c <= limit && cmax[k] == best) {
      ecol = c;
      erow = rmax[k] == cmax[k] ? rrow[k] : kBig;
    }
  }
  const int ecol_all = __reduce_min_sync(kFull, ecol);
  const int erow_all = __shfl_sync(kFull, erow, (ecol_all / C) % kWarp);
  if (lane == 0) {
    out[(size_t)row * 3] = best;
    out[(size_t)row * 3 + 1] = best > 0 ? ecol_all : -1;
    out[(size_t)row * 3 + 2] = best > 0 ? erow_all : m - 1;
  }
}

int launch(const void* codes, int Wp, const void* qp, int qp_stride,
           const void* offs, const void* mreals, const void* terms,
           const void* rlens, int rows, int m, void* out, void* stream) {
  if (rows <= 0) return 0;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarp * kWarpsPerBlock);
  auto st = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const uint8_t*>(codes);
  auto q = static_cast<const int32_t*>(qp);
  auto o = static_cast<const int32_t*>(offs);
  auto mr = static_cast<const int32_t*>(mreals);
  auto te = static_cast<const int32_t*>(terms);
  auto rl = static_cast<const int32_t*>(rlens);
  auto dst = static_cast<int32_t*>(out);
  switch (Wp) {
    case 64:
      window_ends_kernel<2><<<grid, block, 0, st>>>(
          c, q, qp_stride, o, mr, te, rl, rows, m, dst);
      break;
    case 128:
      window_ends_kernel<4><<<grid, block, 0, st>>>(
          c, q, qp_stride, o, mr, te, rl, rows, m, dst);
      break;
    case 256:
      window_ends_kernel<8><<<grid, block, 0, st>>>(
          c, q, qp_stride, o, mr, te, rl, rows, m, dst);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes uint8[rows, Wp] (Wp in {64, 128, 256}); qp int32[3, qp_stride]
// window query rows (q, hi, lo); offs, mreals, terms and rlens
// int32[rows]; out int32[rows, 3].
int fasim_window_general(const void* codes, int Wp, const void* qp,
                         int qp_stride, const void* offs, const void* mreals,
                         const void* terms, const void* rlens, int rows,
                         int m, void* out, void* stream) {
  return launch(codes, Wp, qp, qp_stride, offs, mreals, terms, rlens, rows,
                m, out, stream);
}

}  // extern "C"
