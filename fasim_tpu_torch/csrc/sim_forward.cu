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
// max, and a gap step adds a multiple of 2^32 (one add on the score word).
//   F(i, j) = max(F(i, j-1) - R, C(i, j-1) - (Q + R))
//   pre     = max(diag + s, (0, i (N + 2) + j), F(i, j))
//   C(i, j) = max(pre, D(i, j)),  D(i+1, j) = max(D(i, j), pre - Q) - R
// The restart (diag + s <= 0 takes (0, i (N + 2) + j)) is a max: diag's
// start is before (i, j), so (0, own start) wins exactly when the score
// is <= 0.  The JAX package takes D as a masked lex prefix over C_pre (no
// D term, sim_dev.py:19-24): a D-derived term is strictly dominated
// through the extra gap open.  The same argument drops the D term of C
// from D's own step here.  Down a lane's rows the chain carries E(r) =
// D(i0 + r) + r R: E(r + 1) = max(E(r), pre(r) - Q + r R), one max a row,
// the offsets off the chain.  The plain version (kernels/sim_dev.py:
// sim_forward_ref) keeps JAX's prefix, so the two check each other.
//
// What bounds it on this card.  The cells write 8 bytes each (cs and ct)
// and need 26 int32 operations (chip_smoke.py:SIM_OPS_PER_CELL); at h19_F's
// group (T = 2, m = 2,812, N = 4,366) the bytes take ~0.06 ms of HBM time.
// The time is not that: a pair is one chain of dependent steps.  A strip
// of 32 lanes x kRows query rows (one warp) sweeps the columns as a
// diagonal wavefront (lane k on column step - k, K1's layout), the strip
// below follows it, so a pair takes N + 31 + lag (strips - 1) steps, one
// warp a scheduler and a few hundred cycles a step.  What the first
// version of this kernel lost on top of that, and what this design does:
//  1. Stores.  A lane stored its own rows of one column straight to cs and
//     ct: 32 sectors a store.  Here each warp keeps its band's cells in a
//     ring of shared memory, (cs, ct) pairs addressed (row in band, column
//     mod kCols); lane k writes column step - k, so a step's stores of one
//     row hit every bank once.  Every kDrain steps the warp drains the
//     kDrain columns all its lanes have finished: each row's consecutive
//     words go out as one coalesced store (128 bytes at kDrain = 32).  The
//     ring holds kDrain + 32 columns, the 32 being written and the kDrain
//     waiting.  The drain is still a share of a step's time: a row's
//     segment is rarely 128-byte aligned.
//  2. The strip hand-off.  A strip published its bottom row to global
//     memory 32 columns at a time behind a fence and a flag, and the strip
//     below read a 32-column window: 63 columns of lag a strip, and the
//     fences' time.  Here a strip's lane 31 writes its bottom row (C, next
//     D) one column a step as a 16-byte entry whose four words have bit
//     31 clear, over a scratch filled with 0xff: a reader takes the entry
//     once all four words have it clear, so no flag and no fence.  The
//     strip below takes the row above kBatch columns at a time (lanes
//     0..kBatch-1 read and check an entry each, a batch ahead from L2;
//     lane 0 takes its column by shuffle): kBatch + 31 columns of lag a
//     strip.
//  3. The step itself.  The arithmetic works on the 32-bit words (no carry
//     chain), the score is one prmt of a per-row table, the shuffle of a
//     step's bottom row is issued at its end and read by the next step
//     after the work that does not need it, the loop is split so that the
//     full wavefront runs without bounds checks, and each strip runs code
//     for its own place (whether a row above and a strip below exist).
// On an H100 (chip_smoke.py phase 7, PERF.md §6) a step costs ~240 + 31
// rows ns and a strip lags ~45 steps: a strip's reads and checks of the
// row above, its hand-off store and the drain, not the bytes, set the
// time.  A block is one warp, one strip: blocks of several strips that
// passed the row down through shared memory measured slower at every
// shape the drivers launch (each warp waits on the slowest of its block),
// so the kernel has none.
// Each block takes its strip from a ticket counter in start order, so a
// strip waits only on a strip that already runs: no deadlock, whatever
// order the blocks start in.  A wait that outlasts kWaitNs traps.
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQ = 120;
constexpr int kR = 40;
constexpr long long kOne = 1LL << 32;
// D above query row 1: never wins (every pre is >= (0, 0)), and stays
// far from overflow after m gap steps
constexpr long long kNegKey = -(1LL << 62);

// the columns of the row above a strip takes at a time
constexpr int kBatch = 8;
// shared memory a block can use (H100: 227 KB)
constexpr int kSmemLimit = 232448;
// A D below (-121, 0) never counts in the strip below (C = max(pre, D)
// and max(D, pre - Q) with pre >= (0, 0)), so a hand-off clamps D to it:
// every word of an entry then has bit 31 clear.
constexpr int kDFloor = -121;

// A strip that waits this long on the strip above has met a fault (the
// strip above runs, by the ticket order, and takes milliseconds): trap,
// so the launch fails instead of hanging the card.
constexpr unsigned long long kWaitNs = 20ull * 1000 * 1000 * 1000;

// Each warp's cell ring: kDrain columns a drain, 32 more being written.
// 16 rows a lane drain 16 columns at a time so that one warp's ring fits.
template <int kRows>
struct Ring {
  static constexpr int kBand = kWarp * kRows;
  static constexpr int kDrain = kRows >= 16 ? 16 : 32;
  static constexpr int kCols = kDrain + kWarp;
};

// Dynamic shared memory of a block: its warp's cell ring, (cs, ct) pairs.
template <int kRows>
constexpr int smem_bytes() {
  return Ring<kRows>::kBand * Ring<kRows>::kCols * 8;
}
static_assert(smem_bytes<16>() <= kSmemLimit, "16 rows: the ring too wide");

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

// A key from its words, its score word, and a key plus k << 32: one add on
// the score word, no carry chain.
__device__ __forceinline__ long long join(unsigned lo, int hi) {
  long long r;
  asm("mov.b64 %0, {%1, %2};" : "=l"(r) : "r"(lo), "r"(hi));
  return r;
}

__device__ __forceinline__ int score_of(long long x) {
  int lo, hi;
  asm("mov.b64 {%0, %1}, %2;" : "=r"(lo), "=r"(hi) : "l"(x));
  return hi;
}

__device__ __forceinline__ long long add_score(long long x, int k) {
  int lo, hi;
  asm("mov.b64 {%0, %1}, %2;" : "=r"(lo), "=r"(hi) : "l"(x));
  return join(static_cast<unsigned>(lo), hi + k);
}

// A hand-off entry: (C, D) of a strip's bottom row as four 32-bit words,
// each with bit 31 clear (C's words and t are < 2^31, D's score is stored
// + 121 after the clamp) where the scratch they overwrite has it set.
// Each word is written once by one 16-byte store, and a reader takes an
// entry whose four words all have the bit clear: no flag, no fence.
__device__ __forceinline__ uint4 pack(long long c, long long d) {
  d = kmax(d, key(kDFloor, 0));
  return make_uint4(static_cast<unsigned>(c), static_cast<unsigned>(c >> 32),
                    static_cast<unsigned>(d),
                    static_cast<unsigned>(d >> 32) - kDFloor);
}

__device__ __forceinline__ bool written(uint4 v) {
  return !((v.x | v.y | v.z | v.w) >> 31);
}

__device__ __forceinline__ void unpack(uint4 v, long long& c, long long& d) {
  constexpr unsigned kLow = 0x7fffffffu;
  c = key(static_cast<int>(v.y & kLow), v.x & kLow);
  d = key(static_cast<int>(v.w & kLow) + kDFloor, v.z & kLow);
}

// volatile 16-byte loads and stores of hand-off entries in global memory
struct Entry {
  static __device__ __forceinline__ uint4 load(const uint4* p) {
    uint4 v;
    asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
  }
  static __device__ __forceinline__ void store(uint4* p, uint4 v) {
    asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
};

// A warp that waits on another strip spins a few reads, then sleeps
// between its reads, longer each time up to ~1 us: the strips below wait
// up to milliseconds for the wavefront to reach them, and need not poll
// the memory system all that time.
struct Backoff {
  unsigned long long t0 = now_ns();
  unsigned spins = 0, ns = 32;
  __device__ __forceinline__ void pause() {
    if (++spins < 8) return;  // a strip that runs just ahead: spin
    __nanosleep(ns);
    if (ns < 1024) ns *= 2;
    if (now_ns() - t0 > kWaitNs) __trap();
  }
};

// Wait until the entry at p is written; returns it.
__device__ __forceinline__ uint4 wait_entry(const uint4* p) {
  uint4 v = Entry::load(p);
  if (!written(v)) {
    Backoff b;
    do {
      b.pause();
      v = Entry::load(p);
    } while (!written(v));
  }
  return v;
}

// One warp's strip: 32 lanes x kRows query rows of pair p, swept over the
// columns as a diagonal wavefront.
template <int kRows>
struct Strip {
  static constexpr int kBand = Ring<kRows>::kBand;
  static constexpr int kDrain = Ring<kRows>::kDrain;
  static constexpr int kCols = Ring<kRows>::kCols;

  const int32_t* q;
  const int32_t* ref;  // the pair's reference codes
  int m, N, p, strip, lane;
  const uint4* above;  // the strip above's bottom row
  uint4* below;        // this strip's bottom row
  int2* plane;         // this warp's cells (cs, ct)
  int32_t* cs;
  int32_t* ct;

  // Store the finished columns [jj0, jj0 + kDrain) of the band's rows up
  // to m from the planes: a row's kDrain words go out as one coalesced
  // store.
  __device__ __forceinline__ void drain(int jj0) const {
    __syncwarp();
    constexpr int kRowsAStore = kWarp / kDrain;
    const int jj = jj0 + lane % kDrain;
    const int first = strip * kBand + 1;  // the band's first row
    const int rows = min(kBand, m - first + 1);
    if (jj < N) {
      int rho = lane / kDrain;
      const size_t at =
          (static_cast<size_t>(p) * m + first - 1 + rho) * N + jj;
      int32_t* gs = cs + at;
      int32_t* gt = ct + at;
      const int2* cell = plane + rho * kCols + jj % kCols;
      const size_t skip = static_cast<size_t>(kRowsAStore) * N;
#pragma unroll 8
      for (; rho < rows; rho += kRowsAStore) {
        const int2 v = *cell;
        *gs = v.x;
        *gt = v.y;
        gs += skip;
        gt += skip;
        cell += kRowsAStore * kCols;
      }
    }
    __syncwarp();
  }

  // kAbove: a strip above hands the row above down (else row 0); kBelow:
  // a strip below takes this one's bottom row
  template <bool kAbove, bool kBelow>
  __device__ void sweep() const {
    const unsigned W = static_cast<unsigned>(N) + 2u;
    const int i0 = strip * kBand + lane * kRows + 1;  // the lane's first row
    long long c[kRows], f[kRows];
    unsigned tab[kRows];  // the row's scores + sign bytes for codes 0..3
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      const unsigned t0 = static_cast<unsigned>(i) * W;  // start (i, 0)
      c[r] = key(0, t0);
      f[r] = key(-kQ, t0);
      const int qr = i <= m ? q[i - 1] : 9;  // rows past m: phantom
      unsigned t = 0;  // a code >= 4 on either side scores 0
      if (qr < 4)
        for (int b = 0; b < 4; ++b)
          t |= static_cast<unsigned>(static_cast<uint8_t>(
                   static_cast<int8_t>(b == qr ? 50 : -40)))
               << (8 * b);
      tab[r] = t;
    }
    const unsigned lane_t = static_cast<unsigned>(i0) * W;  // (i0, 0)
    // The row above comes kBatch columns at a time: lane k < kBatch holds
    // column b0 + 1 + k of the batch that starts at step b0, checked and
    // unpacked once, and each step lane 0 takes its column by shuffle.  The
    // entries (L2) are read a batch ahead.
    const uint4 zero = make_uint4(0, 0, 0, 0);
    long long bc = 0, bd = kNegKey;
    uint4 ahead =
        kAbove && lane < kBatch && lane < N ? Entry::load(above + lane) : zero;
    auto batch = [&](int b0) {
      const int jl = b0 + 1 + lane;  // this lane's column
      const bool mine = lane < kBatch && jl <= N;
      uint4 v = ahead;
      if (mine && !written(v)) v = wait_entry(above + jl - 1);
      if (mine) unpack(v, bc, bd);
      ahead = lane < kBatch && jl + kBatch <= N
                  ? Entry::load(above + jl + kBatch - 1)
                  : zero;
    };

    // C of the row above at the previous column: (0, (i0 - 1)(N + 2)) at 0
    long long diag_up = key(0, static_cast<unsigned>(i0 - 1) * W);
    long long out_c = 0, out_d = kNegKey;  // the band's bottom, last step
    // lane k - 1's bottom of the last step (the shuffle of its end)
    long long up_c = 0, up_d = kNegKey;
    int slot = (kCols - lane) % kCols;  // plane column of step - lane
    int code = lane == 0 ? __ldg(ref) : 4;  // this step's code

    // One step: lane k on column st - k + 1.  kAll: every lane's column
    // and the next one are inside [1, N].
    auto step = [&](int st, auto all) {
      constexpr bool kAll = decltype(all)::value;
      if (kAbove && st < N && st % kBatch == 0) batch(st);
      const int j = st - lane + 1;  // this lane's column, 1-based
      const bool live = kAll || (j >= 1 && j <= N);
      // the next step's code, fetched a step ahead
      const int code_next = kAll || (j >= 0 && j < N) ? __ldg(ref + j) : 4;
      // byte `code` of a row's table, sign-extended (a code >= 4 takes
      // byte 4, of the zero word)
      const unsigned sel =
          static_cast<unsigned>(min(code, 4)) * 0x1111u + 0x8880u;
      // what does not need the row above at this column: F, and the
      // diagonal (the last step's) plus s, or the restart (0, i (N + 2) +
      // j) when that is not above (0, 0): the restart's start is past the
      // diagonal's, so the max picks it exactly when the score is <= 0
      long long pre[kRows], fv[kRows];
      {
        long long diag = diag_up;
        const unsigned t_row = lane_t + static_cast<unsigned>(j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          int s;
          asm("prmt.b32 %0, %1, 0, %2;" : "=r"(s) : "r"(tab[r]), "r"(sel));
          fv[r] = kmax(add_score(f[r], -kR), add_score(c[r], -(kQ + kR)));
          const long long v = kmax(
              add_score(diag, s),
              join(t_row + static_cast<unsigned>(r) * W, 0));
          pre[r] = kmax(v, fv[r]);
          diag = c[r];
        }
      }
      // the row above at lane 0's column st + 1
      long long wc = key(0, static_cast<unsigned>(st + 1));  // row 0: (0, j)
      long long wd = kNegKey;
      if (kAbove) {
        wc = __shfl_sync(kFull, bc, st % kBatch);
        wd = __shfl_sync(kFull, bd, st % kBatch);
      }
      if (lane == 0) {
        up_c = wc;
        up_d = wd;
      }
      if (live) {
        diag_up = up_c;
        long long e = up_d;  // E(0) = D(i0)
        int2* cell = plane + lane * kRows * kCols + slot;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const long long cv = kmax(pre[r], add_score(e, -r * kR));
          e = kmax(e, add_score(pre[r], r * kR - kQ));
          c[r] = cv;
          f[r] = fv[r];
          cell[r * kCols] = make_int2(score_of(cv),
                                      static_cast<int32_t>(cv & 0xffffffffLL));
        }
        out_c = c[kRows - 1];
        out_d = add_score(e, -kRows * kR);
      }
      up_c = __shfl_up_sync(kFull, out_c, 1);
      up_d = __shfl_up_sync(kFull, out_d, 1);
      code = code_next;
      slot = slot + 1 == kCols ? 0 : slot + 1;
      // the band's bottom row (lane 31's column st - 30) to the strip below
      if (kBelow && lane == kWarp - 1 && live)
        Entry::store(below + j - 1, pack(out_c, out_d));
      // columns [st - kDrain - 30, st - 30) are finished in every lane
      if (st >= kDrain + kWarp - 2 && (st + 2) % kDrain == 0)
        drain(st - kDrain - (kWarp - 2));
    };
    // the wavefront fills, runs with every lane inside, and empties
    const int fill = min(kWarp - 1, N + kWarp - 1);
    const int full = max(fill, N - 1);
    int st = 0;
    for (; st < fill; ++st) step(st, std::false_type());
    for (; st < full; ++st) step(st, std::true_type());
    for (; st < N + kWarp - 1; ++st) step(st, std::false_type());
    if (N % kDrain != 0) drain((N - 1) / kDrain * kDrain);
  }
};

// q int32[>= m] query codes; refs int32[T, N] reference codes; a block is
// one warp, one strip; bnd uint4[T, strips, N] the strips' bottom rows as
// hand-off entries, every word 0xffffffff (not written) at launch; ticket
// an int, 0 at launch; cs, ct int32[T, m, N].
template <int kRows>
__global__ void __launch_bounds__(kWarp)
sim_forward_kernel(const int32_t* __restrict__ q, int m,
                   const int32_t* __restrict__ refs, int N, int T,
                   int strips, uint4* __restrict__ bnd,
                   int* __restrict__ ticket, int32_t* __restrict__ cs,
                   int32_t* __restrict__ ct) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  int tk = 0;
  if (lane == 0) tk = atomicAdd(ticket, 1);
  tk = __shfl_sync(kFull, tk, 0);
  const int strip = tk / T;
  const int p = tk - strip * T;
  const size_t row = static_cast<size_t>(p) * strips + strip;
  Strip<kRows> x;
  x.q = q;
  x.ref = refs + static_cast<size_t>(p) * N;
  x.m = m;
  x.N = N;
  x.p = p;
  x.strip = strip;
  x.lane = lane;
  x.above = strip > 0 ? bnd + (row - 1) * N : nullptr;
  x.below = bnd + row * N;
  x.plane = reinterpret_cast<int2*>(smem);
  x.cs = cs;
  x.ct = ct;
  const bool below = strip + 1 < strips;
  if (strip == 0)
    below ? x.template sweep<false, true>() : x.template sweep<false, false>();
  else
    below ? x.template sweep<true, true>() : x.template sweep<true, false>();
}

using Kernel = void (*)(const int32_t*, int, const int32_t*, int, int, int,
                        uint4*, int*, int32_t*, int32_t*);

struct Instance {
  Kernel kern;
  int smem;
  int index;  // into g_smem_raised
};

bool instance_for(int rows, Instance* out) {
  switch (rows) {
    case 1: *out = {sim_forward_kernel<1>, smem_bytes<1>(), 0}; return true;
    case 2: *out = {sim_forward_kernel<2>, smem_bytes<2>(), 1}; return true;
    case 4: *out = {sim_forward_kernel<4>, smem_bytes<4>(), 2}; return true;
    case 8: *out = {sim_forward_kernel<8>, smem_bytes<8>(), 3}; return true;
    case 16:
      *out = {sim_forward_kernel<16>, smem_bytes<16>(), 4};
      return true;
    default: return false;
  }
}

// whether each instantiation's dynamic shared memory limit was raised to
// its block's, by device (a function attribute holds for the device it
// was set on); every raise sets the same value, so a race repeats it
constexpr int kMaxDevices = 64;
std::atomic<bool> g_smem_raised[kMaxDevices][5];

}  // namespace

extern "C" {

// Dynamic shared memory of a block at `rows` rows a lane, or -1 if the
// kernel has no such instantiation (rows not 1, 2, 4, 8 or 16).
int fasim_sim_forward_smem(int rows) {
  Instance in;
  return instance_for(rows, &in) ? in.smem : -1;
}

// q int32[>= m] query codes; refs int32[T, N] reference codes; rows the
// query rows a lane (1, 2, 4, 8 or 16) and strips = ceil(m / (32 rows));
// bnd scratch of T * strips * N 16-byte entries, every byte 0xff; ticket
// one int, 0; cs, ct int32[T, m, N].  Returns cudaGetLastError() after the
// launch, or the error of raising the kernel's shared memory limit.
// (m + 1)(N + 2) must be < 2^31.
int fasim_sim_forward(const void* q, int m, const void* refs, int N, int T,
                      int rows, int strips, void* bnd, void* ticket,
                      void* cs, void* ct, void* stream) {
  if (m <= 0 || N <= 0 || T <= 0) return 0;
  Instance in;
  const long long band = static_cast<long long>(kWarp) * rows;
  if (!instance_for(rows, &in) || strips < 1 || strips * band < m ||
      (strips - 1) * band >= m ||
      (static_cast<long long>(m) + 1) * (N + 2) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // past 48 KB, raise the kernel's dynamic shared memory limit, once a
  // device
  if (in.smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices)
      return static_cast<int>(cudaErrorInvalidDevice);
    std::atomic<bool>& raised = g_smem_raised[dev][in.index];
    if (!raised.load()) {
      err = cudaFuncSetAttribute(
          in.kern, cudaFuncAttributeMaxDynamicSharedMemorySize, in.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised.store(true);
    }
  }
  in.kern<<<T * strips, kWarp, static_cast<size_t>(in.smem),
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), m, static_cast<const int32_t*>(refs), N,
      T, strips, static_cast<uint4*>(bnd), static_cast<int*>(ticket),
      static_cast<int32_t*>(cs), static_cast<int32_t*>(ct));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
