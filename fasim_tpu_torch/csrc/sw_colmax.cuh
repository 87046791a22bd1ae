// The DP core shared by K1 (scan.cu), K5 (scan_codes.cu) and K7
// (scan16.cu): warps sweep one code row (or, in K7, two code rows packed
// into the halves of each register) against the query and hand every
// column's exact maximum to the caller.
//
// Exact affine-gap Smith-Waterman, gap open 16 / extend 4.  Query row r
// scores s = code == q ? hi : lo, and in the threshold alphabet s = nv
// where the code is N (5); rows m..m16-1 are zero-profile (phantom rows,
// q = -1, hi = lo = nv = 0) and count toward the column max.
//
// Layout (sweep_columns_fixed): lane k owns a band of kRows consecutive
// query rows, a compile-time count the caller dispatches on
// (sweep_rows(m16) <= kMaxRows), and the warp sweeps the columns as a
// diagonal wavefront (lane k works on column step - k).  The H and F of
// the row above a band and the running column max pass down the warp by
// shuffles, so the vertical gap is exact at any length.  Queries taller
// than one strip of 32 bands run strip after strip; the rows the strips
// hold beyond m16 sit above row 0 as zero-score rows, and a strip's bottom
// row (H, F, column max) goes to the next strip 32 columns at a time,
// through shared memory and a global scratch row or, in a pipelined block,
// a ring in shared memory to the next warp.  The bottom lanes of the last
// strip own the finished column maxima, 32 columns at a time.
//
// The cell arithmetic is a policy, three cells in all, each keeping G = H -
// 16 (also in the hand-offs and the scratch row) against a table of scores
// + 16, so that a cell costs 7 operations on Hopper's DPX forms:
//   * CellI32Dpx (K1): one int32 cell per register.  A row is one of at
//     most 8 score classes; the column's code picks an 8-byte table of the
//     classes' scores + 16 from shared memory once per column, and each
//     row's prmt selector picks its class's byte.
//   * CellI32DpxT<true> (K5): the same cell with the short chain of
//     dependent operations down a lane's rows; K5 also runs a code row's
//     strips at once, one warp each (a pipelined block).
//   * CellS16x2T (K7): two int16 cells per register on the s16x2 forms,
//     with the short chain below 16 rows a lane; a row keeps its own 8-byte
//     table and the column's word is the prmt selector of its two codes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fasim {

constexpr int kGapOpen = 16;
constexpr int kGapExtend = 4;
constexpr int kWarp = 32;
constexpr int kMaxRows = 16;  // query rows per lane in one strip
// warps of a pipelined block: its rings meet on named barriers 1..15
constexpr int kMaxWarps = 16;
constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

// int32 cells on Hopper's DPX forms.  A query row is one of at most 8 score
// classes (class 0 scores 0 for every code: the phantom rows and the rows
// sweep_columns_fixed adds above row 0); a column word is the 8-byte table
// of the classes' scores + 16 for the column's code, and a row keeps the
// prmt selector of its class, which sign-extends that byte to 32 bits.
// The cell keeps G = H - 16: the table's + 16 makes G the diagonal operand
// and both gaps read G, so a cell costs 7 operations: the score (prmt), E
// and F (one __viaddmax each), H (__viaddmax_relu of the diagonal and E,
// then a max with F), G and the column max.  No overflow: G >= -16, a table
// byte <= 21, and E, F >= -20 after the first row and column.
//
// kShort (K5) shortens the chain of dependent operations down a lane's rows
// from three a row (F, H, G) to one, at the same 7 operations a cell.  As
// F(r) = max(F(r-1) - 4, H(r-1) - 16) and H(r-1) = max(tmp(r-1), F(r-1)),
// where tmp is H before the vertical gap, F(r) = max(F(r-1) - 4, tmp(r-1) -
// 16): the F - 16 term never wins.  So the cell keeps F + 16 (also in the
// hand-offs) and takes row r's F from F(r-1) and tmp(r-1) alone, one
// __viaddmax, and H = max(tmp, F) is one __viaddmax of F + 16 off the chain.
// Row 0 of a band takes the H of the row above, G + 16 (carry_in), and the
// band hands down its bottom row's G (carry_out).  K1, whose warps fill the
// card (its time is instruction throughput, not latency), keeps the
// three-step form.
template <bool kShort = false>
struct CellI32DpxT {
  using Word = int;
  struct Row {
    int g, e;
    unsigned sel;
  };
  static constexpr int kTop = kNeg;        // F above query row 0
  static constexpr int kH0 = -kGapOpen;    // G of H = 0

  // byte k of the 8-byte table, its sign in the other three bytes
  static __host__ __device__ constexpr unsigned selector(int k) {
    return static_cast<unsigned>(k | (k | 8) << 4 | (k | 8) << 8 |
                                 (k | 8) << 12);
  }
  __device__ __forceinline__ static Row row(int k) {
    return Row{kH0, 0, selector(k)};
  }
  __device__ __forceinline__ static int zero_query() { return 0; }
  __device__ __forceinline__ static int carry_in(int g) {
    return kShort ? g + kGapOpen : g;
  }
  __device__ __forceinline__ static int carry_out(int gu, const Row& last) {
    return kShort ? last.g : gu;
  }

  // One cell, every H word in G form: diag is G(r-1, j-1) on entry and
  // G(r, j-1) on exit, gu G(r-1, j) -> G(r, j), f F(r-1, j) -> F(r, j);
  // E(r, j) = max(E(r, j-1) - 4, H(r, j-1) - 16); cm takes H.  kShort: f
  // holds F + 16, and gu H(r-1, j) (row 0) or tmp(r-1, j) -> tmp(r, j).
  __device__ __forceinline__ static void step(Row& w, uint2 t, int& diag,
                                              int& gu, int& f, int& cm) {
    int s;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(s) : "r"(t.x), "r"(t.y),
        "r"(w.sel));
    const int ev = __viaddmax_s32(w.e, -kGapExtend, w.g);
    const int tmp = __viaddmax_s32_relu(diag, s, ev);
    if constexpr (kShort) {
      f = __viaddmax_s32(f, -kGapExtend, gu);
      const int hv = __viaddmax_s32(f, -kGapOpen, tmp);
      diag = w.g;
      w.g = hv - kGapOpen;
      w.e = ev;
      gu = tmp;
      cm = max(cm, hv);
    } else {
      f = __viaddmax_s32(f, -kGapExtend, gu);
      const int hv = max(tmp, f);
      diag = w.g;
      w.g = hv - kGapOpen;
      w.e = ev;
      gu = w.g;
      cm = max(cm, hv);
    }
  }
};
using CellI32Dpx = CellI32DpxT<false>;

// Two int16 cells per 32-bit register (K7), on Hopper's s16x2 DPX forms:
// the cells of two (segment, transform) pairs against the same query row,
// the first pair's in the low half and the second's in the high half.  The
// roles of CellI32DpxT's words swap: a query row keeps its own 8-byte table
// (s + 16 for each engine code 0..7, scan.py:scan16_table) and the
// column's word is the prmt selector of its two codes, each with a
// sign-replicating copy, so one prmt scores both halves.  The rest is
// CellI32DpxT's cell in G = H - 16 form, kShort its short F chain
// included: 7 operations per two cells, with no conversion in the
// hand-offs.  Exact while every H fits in int16: the caller's gate, H <= 5
// * min(m16, N) <= 30000, keeps diag + s + 16 <= 30005; E and F stay >=
// -20 after the first row and column, and the F sentinel kTop (-16384)
// meets G >= -16 at the first row (a zero-score row above row 0 or row
// 0), so it never decays far.
template <bool kShort = false>
struct CellS16x2T {
  using Word = unsigned;
  struct Row {
    unsigned g, e, tlo, thi;
  };
  static constexpr unsigned kTop = 0xC000C000u;  // -16384 in both halves
  static constexpr unsigned kH0 = 0xFFF0FFF0u;   // G of H = 0: -16
  static constexpr unsigned kMin = 0x80008000u;  // -32768: max(x, kMin) = x
  static constexpr unsigned kM4 = 0xFFFCFFFCu;   // -4
  static constexpr unsigned kM16 = 0xFFF0FFF0u;  // -16
  static constexpr unsigned kP16 = 0x00100010u;  // +16

  // codes ca (low half) and cb (high half), each < 8
  static __host__ __device__ constexpr unsigned selector(int ca, int cb) {
    return static_cast<unsigned>(ca | (ca | 8) << 4 | cb << 8 |
                                 (cb | 8) << 12);
  }
  // t: the row's table, codes 0..3 in t.x and 4..7 in t.y
  __device__ __forceinline__ static Row row(uint2 t) {
    return Row{kH0, 0, t.x, t.y};
  }
  // the table of a zero-score row: s + 16 = 16 for every code
  __device__ __forceinline__ static uint2 zero_query() {
    return make_uint2(0x10101010u, 0x10101010u);
  }
  __device__ __forceinline__ static unsigned carry_in(unsigned g) {
    return kShort ? __viaddmax_s16x2(g, kP16, kMin) : g;
  }
  __device__ __forceinline__ static unsigned carry_out(unsigned gu,
                                                       const Row& last) {
    return kShort ? last.g : gu;
  }

  // CellI32DpxT::step for two cells, sel the column's selector.
  __device__ __forceinline__ static void step(Row& w, unsigned sel,
                                              unsigned& diag, unsigned& gu,
                                              unsigned& f, unsigned& cm) {
    unsigned s;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(s) : "r"(w.tlo), "r"(w.thi),
        "r"(sel));
    const unsigned ev = __viaddmax_s16x2(w.e, kM4, w.g);
    const unsigned tmp = __viaddmax_s16x2_relu(diag, s, ev);
    f = __viaddmax_s16x2(f, kM4, gu);
    const unsigned hv =
        kShort ? __viaddmax_s16x2(f, kM16, tmp) : __vimax_s16x2_relu(tmp, f);
    diag = w.g;
    w.g = __viaddmax_s16x2(hv, kM16, kMin);
    w.e = ev;
    gu = kShort ? tmp : w.g;
    cm = __vimax_s16x2_relu(cm, hv);
  }
};

// Strips and rows per lane of a query of m16 rows at most max_rows rows a
// lane: the rows spread evenly over the strips, so that the last one is
// not mostly idle.  A sweep of kRows rows a lane runs sweep_strips(m16,
// kRows) strips (for kRows = sweep_rows(m16, r) as many as for r).
__host__ __device__ inline int sweep_strips(int m16, int max_rows = kMaxRows) {
  return (m16 + kWarp * max_rows - 1) / (kWarp * max_rows);
}
__host__ __device__ inline int sweep_rows(int m16, int max_rows = kMaxRows) {
  const int nstrips = sweep_strips(m16, max_rows);
  return (m16 + kWarp * nstrips - 1) / (kWarp * nstrips);
}

// Warps w - 1 and w of a pipelined block meet on named barrier w (64
// threads; it also orders their shared-memory accesses).
__device__ __forceinline__ void ring_sync(int id) {
  asm volatile("barrier.sync %0, 64;" ::"r"(id) : "memory");
}

// Wait until another warp of the block has published `target` (a count in
// shared memory, raised after the stores it covers).
__device__ __forceinline__ void wait_count(const int* count, int target) {
  while (*static_cast<const volatile int*>(count) < target) {
  }
  __threadfence_block();
}

// The sweep of K1, K5 and K7: the wavefront with every lane stepping
// exactly kRows rows (the caller dispatches on it), so the row loop is
// straight code.  The strips hold sweep_strips(m16, kRows) * 32 * kRows
// rows; those beyond m16 go above row 0 as rows of Cell::zero_query(), which
// score 0: such a row keeps H = 0 under a top boundary of H = 0 (G =
// Cell::kH0; diag + 0, E and F <= 0) and hands row 0 F = -16, which it gets
// from H(-1, j) = 0 anyway, so the DP and every column max are unchanged.
//
// A strip's bottom row goes to the next strip in blocks of 32 columns, one
// column a lane, so no step branches on the lane: lane 31 writes its H, F
// and column max into a staging block in shared memory and lane 0 of the
// next strip reads them from one.
//   * One warp (kPipe false; K1, K7, and K5 with many code rows) runs the
//     strips one after another.  Every 32 columns the warp stores its
//     outputs' block to the global scratch row; lane 0 reads the row above
//     the strip from a staging block that the warp fills from the scratch
//     row, which it fetches a block ahead.
//   * A pipelined block (kPipe, K5 with few code rows) runs a code row's
//     strips at once: warp w of W takes strips w, w + W, w + 2W, ...  Warp
//     w hands its strips' bottom rows to warp w + 1 through a ring of two
//     32-column blocks in shared memory.  The two warps meet on named
//     barrier w + 1 once a block: warp w when it has written the block,
//     warp w + 1 before it reads it, so warp w + 1 runs two blocks (63
//     steps) behind and neither overwrites a block the other still reads.
//     A block's ring slot alternates, counted over every block the pair
//     has moved (so a strip of an odd number of blocks does not restart
//     the slot the other warp still reads).  With more strips than warps,
//     warp W - 1 hands its strips to warp 0 through the global scratch row
//     (the wrap), a block at a time: it publishes the blocks it has stored
//     in a shared count, which warp 0 waits for (a block ahead, for its
//     fetch).  The wrap does not block warp W - 1, so no cycle of waits
//     closes.  The next strip of warp W - 1 trails the strip of warp 0
//     that read the scratch row by the W - 1 ring hand-offs between them,
//     two blocks each, so warp 0 has read a block before it is written
//     again.  A pipelined block's warps also fetch each column's word a
//     step ahead, off the step's chain of dependent operations.
//
// col(j): column j's word for Cell::step (a call after the caller's codes
// are written and a __syncwarp, or a __syncthreads when pipelined);
// load(row) -> the argument of Cell::row for rows < m16; bnd: Word[3, N]
// scratch (read only with more strips than warps); emit(j, cm) runs on
// lane j % 32 of the warp of the last strip for every column j, 32 columns
// at a time.  A pipelined block has blockDim.x / 32 <= kMaxWarps warps.
template <class Cell, int kRows, bool kPipe = false, class Col, class Load,
          class Emit>
__device__ __forceinline__ void sweep_columns_fixed(
    Col col, int N, int m16, typename Cell::Word* bnd, Load load,
    Emit emit) {
  using Word = typename Cell::Word;
  __shared__ Word stage_in[3][kWarp];  // H, F, column max above the strip
  // each warp's lane 31's H, F, column max (stored to bnd or emitted)
  __shared__ Word stage_out[kPipe ? kMaxWarps : 1][3][kWarp];
  __shared__ Word ring[kPipe ? kMaxWarps - 1 : 1][2][3][kWarp];  // w -> w+1
  __shared__ int wrap_done;  // blocks of bnd published by warp W - 1
  const int lane = threadIdx.x % kWarp;
  const int warp = kPipe ? static_cast<int>(threadIdx.x) / kWarp : 0;
  const int warps = kPipe ? static_cast<int>(blockDim.x) / kWarp : 1;
  const int nstrips = sweep_strips(m16, kRows);
  const int nblocks = (N + kWarp - 1) / kWarp;
  const int pad = nstrips * kWarp * kRows - m16;  // zero rows above row 0
  Word* bh = bnd;  // used only with more strips than warps
  Word* bf = bh + N;
  Word* bc = bf + N;
  if (kPipe) {
    if (threadIdx.x == 0) wrap_done = 0;
    __syncthreads();
  }
  for (int strip = warp; strip < nstrips; strip += warps) {
    const int row0 = (strip * kWarp + lane) * kRows - pad;
    typename Cell::Row w[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      w[r] = Cell::row(row0 + r >= 0 ? load(row0 + r) : Cell::zero_query());
    const bool first = strip == 0;
    const bool last = strip == nstrips - 1;
    // pipelined: the strip above comes through the ring of the warp above
    // (warp 0: through bnd), this one goes through this warp's ring (warp W
    // - 1: through bnd)
    const bool ring_in = kPipe && !first && warp > 0;
    const bool ring_out = kPipe && !last && warp < warps - 1;
    // the blocks this warp's earlier strips moved through its rings
    const int moved = kPipe ? (strip - warp) / warps * nblocks : 0;
    // the wrap's count before the strip that feeds this one (warp 0) and
    // before this one (warp W - 1)
    const int wrap_in = kPipe ? (strip / warps - 1) * nblocks : 0;
    const int wrap_out = kPipe ? ((strip + 1) / warps - 1) * nblocks : 0;
    Word up_prev = Cell::kH0;  // H of the row above the band, last column
    Word out_h = Cell::kH0, out_f = Cell::kTop, out_c = 0;
    // the scratch row's next block, column 32 * block + lane
    Word next_h = Cell::kH0, next_f = Cell::kTop, next_c = 0;
    Word(*in)[kWarp] = stage_in;  // the block above the strip
    // lane 31's block of outputs: this warp's ring slot or staging block
    Word(*out)[kWarp] = ring_out ? ring[warp][moved % 2] : stage_out[warp];
    // pipelined: the column word of the next step, fetched a step ahead
    decltype(col(0)) col_next{};
    if (kPipe) col_next = col(0);
    if (!first && !ring_in) {
      if (kPipe) wait_count(&wrap_done, wrap_in + 1);
      if (lane < N) {
        next_h = bh[lane];
        next_f = bf[lane];
        next_c = bc[lane];
      }
    }
    for (int step = 0; step < N + kWarp - 1; ++step) {
      const int k = step % kWarp;
      if (!first && k == 0) {
        if (ring_in) {
          if (step < N) {  // the warp above has written block step / 32
            ring_sync(warp);
            in = ring[warp - 1][(moved + step / kWarp) % 2];
          }
        } else {
          __syncwarp();
          stage_in[0][lane] = next_h;
          stage_in[1][lane] = next_f;
          stage_in[2][lane] = next_c;
          if (kPipe)
            wait_count(&wrap_done, wrap_in + min(step / kWarp + 2, nblocks));
          const int jn = step + kWarp + lane;
          if (jn < N) {
            next_h = bh[jn];
            next_f = bf[jn];
            next_c = bc[jn];
          }
          __syncwarp();
        }
      }
      Word in_h = __shfl_up_sync(kFull, out_h, 1);
      Word in_f = __shfl_up_sync(kFull, out_f, 1);
      Word in_c = __shfl_up_sync(kFull, out_c, 1);
      if (lane == 0) {  // column step: the top boundary or the strip above
        in_h = first ? Cell::kH0 : in[0][k];
        in_f = first ? Cell::kTop : in[1][k];
        in_c = first ? 0 : in[2][k];
      }
      const int j = step - lane;
      const auto col_now = col_next;
      if (kPipe) col_next = col(min(max(j + 1, 0), N - 1));
      if (j >= 0 && j < N) {
        const auto c = kPipe ? col_now : col(j);
        Word diag = up_prev;
        up_prev = in_h;
        Word hu = Cell::carry_in(in_h), f = in_f, cm = in_c;
#pragma unroll
        for (int r = 0; r < kRows; ++r) Cell::step(w[r], c, diag, hu, f, cm);
        out_h = Cell::carry_out(hu, w[kRows - 1]);
        out_f = f;
        out_c = cm;
      }
      const int j31 = step - (kWarp - 1);  // lane 31's column
      if (j31 >= 0) {
        if (lane == kWarp - 1) {
          out[0][j31 % kWarp] = out_h;
          out[1][j31 % kWarp] = out_f;
          out[2][j31 % kWarp] = out_c;
        }
        if (j31 % kWarp == kWarp - 1 || j31 == N - 1) {
          __syncwarp();
          if (ring_out) {
            ring_sync(warp + 1);  // block j31 / 32 is in the ring
            out = ring[warp][(moved + j31 / kWarp + 1) % 2];
          } else {
            const int jb = j31 - j31 % kWarp + lane;
            if (jb <= j31) {
              if (last) {
                emit(jb, out[2][lane]);
              } else {
                bh[jb] = out[0][lane];
                bf[jb] = out[1][lane];
                bc[jb] = out[2][lane];
              }
            }
            if (kPipe && !last) {  // the wrap: publish the block to warp 0
              __syncwarp();
              if (lane == 0) {
                __threadfence_block();
                *static_cast<volatile int*>(&wrap_done) =
                    wrap_out + j31 / kWarp + 1;
              }
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

// Opt a kernel into more than 48 KB of shared memory, static and dynamic.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kern, size_t smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess || attr.sharedSizeBytes + smem <= 48 * 1024)
    return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace fasim
