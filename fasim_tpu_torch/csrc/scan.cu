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
// What bounds it on this card: int32 ALU throughput.  Every cell costs ~14
// integer ops (compare/select, three max-with-add chains) and reads no
// memory: the segment codes sit in shared memory and the query profile in
// registers.  Design: one warp per pair; lane k owns a band of up to
// kMaxRows consecutive query rows and the warp sweeps the segment columns
// as a diagonal wavefront (lane k works on column step - k).  The H and F
// of the row above a band and the running column max pass down the warp
// by shuffles, so the vertical gap is exact at any length (there is no
// 64-lane prefix window as on the TPU, and full_prefix changes nothing).
// Queries taller than one strip of 32 * kMaxRows rows run strip after
// strip; a strip's bottom row (H, F, column max) goes through a global
// scratch row read back by the next strip.  The bottom lane of the last
// strip owns the finished column max.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGapOpen = 16;
constexpr int kGapExtend = 4;
constexpr int kWarp = 32;
constexpr int kMaxRows = 16;  // query rows per lane in one strip
constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

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

  // spread the rows evenly over the strips so the last one is not mostly idle
  const int nstrips = (m16 + kWarp * kMaxRows - 1) / (kWarp * kMaxRows);
  const int rpt = (m16 + kWarp * nstrips - 1) / (kWarp * nstrips);
  int32_t* bh = bnd + (size_t)pair * 3 * N;  // used only with >1 strip
  int32_t* bf = bh + N;
  int32_t* bc = bf + N;
  int gmax = 0;
  for (int strip = 0; strip < nstrips; ++strip) {
    const int row0 = (strip * kWarp + lane) * rpt;
    const int nr = max(0, min(rpt, m16 - row0));
    int h[kMaxRows], e[kMaxRows], q[kMaxRows], hi[kMaxRows], lo[kMaxRows],
        nv[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      const bool ok = r < nr;
      h[r] = 0;
      e[r] = 0;
      q[r] = ok ? qp[row0 + r] : -1;
      hi[r] = ok ? qp[qp_stride + row0 + r] : 0;
      lo[r] = ok ? qp[2 * qp_stride + row0 + r] : 0;
      nv[r] = (kThresh && ok) ? qp[3 * qp_stride + row0 + r] : 0;
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
            if (cm_out != nullptr)
              cm_out[(size_t)pair * N + j] = (uint8_t)min(cm, 255);
            gmax = max(gmax, cm);
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
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
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
