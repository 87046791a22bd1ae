// K8 sim_forward: the forward scan of the exact SIM engine (-F under
// FASIM_SIM_DEVICE=1): every cell's lexicographic maximum of (score,
// packed start t = si * (N + 2) + sj), for T pairs of one query.
//
// Replaces fasim_tpu/kernels/sim_dev.py:_sim_forward (XLA, a lax.scan over
// the reference columns with the query on lanes; not Pallas).  Contract
// (sim.h:511-567): match 50, mismatch -40, 0 where either code is >= 4
// (N in the reference, a non-ACGT query byte, the pad code 9); gap open
// Q = 120, extend R = 40 (10x units); a cell restarts at (0, its own
// start) when diag + s <= 0; the diagonal into query row 1 is (0, j - 1)
// and column 0 holds (0, i (N + 2)) with F = (-Q, i (N + 2)).  The output
// is cs / ct int32[T, m, N], query rows first (the host's scan order).
//
// The recurrence, on one signed int64 key a (score, t) pair,
// (score << 32) | t, whose order is the lexicographic one because 0 <= t
// < 2^31 (the caller's gate, (m + 1)(N + 2) < 2^31): a lex max is an int64
// max, and a gap step subtracts a multiple of 2^32.
//   F(i, j) = max(F(i, j-1) - R, C(i, j-1) - (Q + R))
//   pre     = diag + s <= 0 ? (0, i (N + 2) + j) : diag + s
//   pre     = max(pre, F(i, j))
//   C(i, j) = max(pre, D(i, j)),  D(i+1, j) = max(D(i, j) - R, pre - (Q+R))
// The JAX package takes D as a masked lex prefix over C_pre (no D term,
// sim_dev.py:19-24): a D-derived term is strictly dominated through the
// extra gap open.  The same argument drops the D term of C from D's own
// step here (C - (Q + R) = max(pre, D) - (Q + R), and D - (Q + R) < D - R),
// which shortens the chain of dependent operations down the rows to one
// subtraction and one max.  The plain version (kernels/sim_dev.py:
// sim_forward_ref) keeps JAX's prefix, so the two check each other.
//
// What bounds it on this card: bytes.  The cells write 8 bytes each (cs
// and ct) and need 26 int32 operations (chip_smoke.py:
// SIM_OPS_PER_CELL); at h19_F's group (T = 2, m = 2,812, N = 4,366) the
// bytes take ~0.06 ms of HBM time.  The work is one chain of dependent
// steps a pair, and a call holds 1-8 pairs, so what the time really
// follows is the latency of a step times the steps of the longest chain.
//
// Design: K1's layout (sw_colmax.cuh), one warp a strip of 32 lanes x
// kRows query rows, the warp sweeping the columns as a diagonal wavefront
// (lane k on column step - k); a band's bottom (C, next D) passes down the
// warp by shuffles.  Every strip of every pair is its own one-warp block,
// so a pair's strips run at once on many SMs: a strip's bottom row goes
// to the strip below through a global row, published 32 columns at a time
// with a release flag; the strip below reads a 32-column window of it
// when its top lane reaches the window.  A block takes its strip from a
// ticket counter, so a block waits only on a strip that a running block
// already holds: no deadlock, whatever order the blocks start in.  The
// cells are stored straight from the lanes (a lane's rows of one column),
// not staged for coalescing: that is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQ = 120;
constexpr int kR = 40;
constexpr long long kOne = 1LL << 32;
constexpr long long kStepR = static_cast<long long>(kR) << 32;
constexpr long long kStepQR = static_cast<long long>(kQ + kR) << 32;
// D above query row 1: never wins (every pre is >= (0, 0)), and stays
// far from overflow after m gap steps
constexpr long long kNegKey = -(1LL << 62);

// A strip that waits this long on the strip above has met a fault (the
// strip above runs, by the ticket order, and takes milliseconds): trap,
// so the launch fails instead of hanging the card.
constexpr unsigned long long kWaitNs = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ long long key(int score, unsigned t) {
  return static_cast<long long>(score) * kOne + t;
}

__device__ __forceinline__ long long kmax(long long a, long long b) {
  return a > b ? a : b;
}

// q int32[>= m] query codes; refs int32[T, N] reference codes; bnd
// longlong2[T, strips, N] the strips' bottom rows (C, D of the row below);
// flags int32[T * strips + 1]: the columns each strip has published, then
// the ticket counter, all 0 at launch; cs, ct int32[T, m, N].
template <int kRows>
__global__ void __launch_bounds__(kWarp)
sim_forward_kernel(const int32_t* __restrict__ q, int m,
                   const int32_t* __restrict__ refs, int N, int T,
                   int strips, longlong2* __restrict__ bnd,
                   int* __restrict__ flags, int32_t* __restrict__ cs,
                   int32_t* __restrict__ ct) {
  const int lane = threadIdx.x;
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(flags + T * strips, 1);
  ticket = __shfl_sync(kFull, ticket, 0);
  const int strip = ticket / T;
  const int p = ticket - strip * T;
  const unsigned W = static_cast<unsigned>(N) + 2u;
  const int i0 = strip * kWarp * kRows + lane * kRows + 1;  // first row
  const int32_t* ref = refs + static_cast<size_t>(p) * N;
  volatile int* above_flag =
      strip > 0 ? flags + p * strips + strip - 1 : nullptr;
  const longlong2* above = bnd + (static_cast<size_t>(p) * strips +
                                  (strip > 0 ? strip - 1 : 0)) * N;
  longlong2* below = bnd + (static_cast<size_t>(p) * strips + strip) * N;
  int* below_flag = flags + p * strips + strip;
  const bool publish = strip + 1 < strips && lane == kWarp - 1;

  long long c[kRows], f[kRows];
  int qc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r;
    const unsigned t0 = static_cast<unsigned>(i) * W;  // start (i, 0)
    c[r] = key(0, t0);
    f[r] = key(-kQ, t0);
    qc[r] = i <= m ? q[i - 1] : 9;  // rows past m: phantom, never stored
  }
  // C of the row above at the previous column: (0, (i0 - 1)(N + 2)) at 0
  long long diag_up = key(0, static_cast<unsigned>(i0 - 1) * W);
  long long out_c = 0, out_d = kNegKey;  // the band's bottom, last step
  long long win_c = 0, win_d = kNegKey;  // lane 0's window of the above
  for (int st = 0; st < N + kWarp - 1; ++st) {
    if ((st & (kWarp - 1)) == 0) {
      // the next 32 columns of the row above the strip, lane k column
      // st + k + 1 (1-based)
      const int jw = st + lane + 1;
      if (strip == 0) {
        win_c = key(0, static_cast<unsigned>(jw));  // row 0: (0, j)
        win_d = kNegKey;
      } else {
        const int need = min(st + kWarp, N);
        if (*above_flag < need) {
          const unsigned long long t0 = now_ns();
          while (*above_flag < need) {
            __nanosleep(32);
            if (now_ns() - t0 > kWaitNs) __trap();
          }
        }
        __threadfence();
        if (jw <= N) {
          const longlong2 v = __ldcg(above + jw - 1);
          win_c = v.x;
          win_d = v.y;
        }
      }
    }
    long long up_c = __shfl_up_sync(kFull, out_c, 1);
    long long up_d = __shfl_up_sync(kFull, out_d, 1);
    const long long w_c = __shfl_sync(kFull, win_c, st & (kWarp - 1));
    const long long w_d = __shfl_sync(kFull, win_d, st & (kWarp - 1));
    if (lane == 0) {
      up_c = w_c;
      up_d = w_d;
    }
    const int j = st - lane + 1;  // this lane's column, 1-based
    if (j < 1 || j > N) continue;
    const int code = __ldg(ref + j - 1);
    long long diag = diag_up;
    diag_up = up_c;
    long long d = up_d;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qr = qc[r];
      const int s = (qr | code) < 4 ? (qr == code ? 50 : -40) : 0;
      const long long fv = kmax(f[r] - kStepR, c[r] - kStepQR);
      long long pre = diag + static_cast<long long>(s) * kOne;
      if (pre < kOne)  // score <= 0: restart at (0, i (N + 2) + j)
        pre = static_cast<long long>(
            static_cast<unsigned>(i0 + r) * W + static_cast<unsigned>(j));
      pre = kmax(pre, fv);
      const long long cv = kmax(pre, d);
      d = kmax(d - kStepR, pre - kStepQR);
      diag = c[r];
      c[r] = cv;
      f[r] = fv;
      const int i = i0 + r;
      if (i <= m) {
        const size_t at =
            (static_cast<size_t>(p) * m + (i - 1)) * N + (j - 1);
        cs[at] = static_cast<int32_t>(cv >> 32);
        ct[at] = static_cast<int32_t>(cv & 0xffffffffLL);
      }
    }
    out_c = c[kRows - 1];
    out_d = d;
    if (publish) {
      below[j - 1] = make_longlong2(out_c, out_d);
      if ((j & (kWarp - 1)) == 0 || j == N) {
        __threadfence();
        atomicExch(below_flag, j);
      }
    }
  }
}

using Kernel = void (*)(const int32_t*, int, const int32_t*, int, int, int,
                        longlong2*, int*, int32_t*, int32_t*);

Kernel kernel_for(int rows) {
  switch (rows) {
    case 1: return sim_forward_kernel<1>;
    case 2: return sim_forward_kernel<2>;
    case 4: return sim_forward_kernel<4>;
    case 8: return sim_forward_kernel<8>;
    case 16: return sim_forward_kernel<16>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// q int32[>= m] query codes; refs int32[T, N] reference codes; rows the
// query rows a lane (1, 2, 4, 8 or 16) and strips = ceil(m / (32 rows));
// bnd scratch of T * strips * N 16-byte entries; flags int32[T * strips +
// 1] zeroed; cs, ct int32[T, m, N].  (m + 1)(N + 2) must be < 2^31.
int fasim_sim_forward(const void* q, int m, const void* refs, int N, int T,
                      int rows, int strips, void* bnd, void* flags, void* cs,
                      void* ct, void* stream) {
  if (m <= 0 || N <= 0 || T <= 0) return 0;
  const Kernel kern = kernel_for(rows);
  const long long band = static_cast<long long>(kWarp) * rows;
  if (kern == nullptr || strips < 1 || strips * band < m ||
      (strips - 1) * band >= m ||
      (static_cast<long long>(m) + 1) * (N + 2) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  kern<<<T * strips, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), m, static_cast<const int32_t*>(refs), N,
      T, strips, static_cast<longlong2*>(bnd), static_cast<int*>(flags),
      static_cast<int32_t*>(cs), static_cast<int32_t*>(ct));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
