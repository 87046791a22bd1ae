// The DP core shared by K1 (scan.cu), K5 (scan_codes.cu) and K7
// (scan16.cu): one warp sweeps one code row (or, in K7, two code rows
// packed into the halves of each register) against the query and hands
// every column's exact maximum to the caller.
//
// Exact affine-gap Smith-Waterman, gap open 16 / extend 4.  Query row r
// scores s = code == q ? hi : lo, and in the threshold alphabet s = nv
// where the code is N (5); rows m..m16-1 are zero-profile (phantom rows,
// q = -1, hi = lo = nv = 0) and count toward the column max.
//
// Layout: lane k owns a band of up to kMaxRows consecutive query rows and
// the warp sweeps the columns as a diagonal wavefront (lane k works on
// column step - k).  The H and F of the row above a band and the running
// column max pass down the warp by shuffles, so the vertical gap is exact
// at any length.  Queries taller than one strip of 32 * kMaxRows rows run
// strip after strip; a strip's bottom row (H, F, column max) goes through
// a global scratch row read back by the next strip.  The bottom lane of
// the last strip owns the finished column max.
//
// The cell arithmetic is a policy:
//   * CellI32Dpx (K1): one int32 cell per register on Hopper's DPX forms,
//     7 operations a cell in either alphabet.  A row is one of at most 8
//     score classes; the column's code picks an 8-byte table of the classes'
//     scores + 16 from shared memory once per column, and each row's prmt
//     selector picks its class's byte.  The cell keeps G = H - 16, also in
//     the hand-offs and the scratch row.  K1 fixes the rows per lane at
//     compile time (sweep_columns_fixed), with zero-score rows above row 0.
//   * CellI32 (K5): one int32 cell per register, the score by compare and
//     select from the row's (q, hi, lo, nv), 13 or 14 integer operations.
//   * CellS16x2 (K7): two int16 cells per register, s16x2 DPX forms.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fasim {

constexpr int kGapOpen = 16;
constexpr int kGapExtend = 4;
constexpr int kWarp = 32;
constexpr int kMaxRows = 16;  // query rows per lane in one strip
constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

// One query row's scoring: s = code == q ? hi : lo (nv: the threshold
// alphabet's score of a reference N).
struct QueryRow {
  int q, hi, lo, nv;
};

// int32 cells: codes are uint8 engine codes.
template <bool kThresh>
struct CellI32 {
  using Word = int;
  using Code = uint8_t;
  struct Row {
    int h, e, q, hi, lo, nv;
  };
  static constexpr int kTop = kNeg;  // F above query row 0

  __device__ __forceinline__ static Row row(QueryRow qr) {
    return Row{0, 0, qr.q, qr.hi, qr.lo, kThresh ? qr.nv : 0};
  }
  // the H handed down the warp, in the form step() reads as `hu`
  __device__ __forceinline__ static int carry_in(int h) { return h; }
  __device__ __forceinline__ static int carry_out(int hu) { return hu; }

  // One cell: diag is H(r-1, j-1) on entry and H(r, j-1) on exit; hu is
  // H(r-1, j) on entry and H(r, j) on exit; f is F(r-1, j) -> F(r, j).
  __device__ __forceinline__ static void step(Row& w, int c, int& diag,
                                              int& hu, int& f, int& cm) {
    int sc = c == w.q ? w.hi : w.lo;
    if (kThresh && c == 5) sc = w.nv;
    const int ev = max(w.e - kGapExtend, w.h - kGapOpen);
    const int tmp = max(max(diag + sc, ev), 0);
    f = max(hu - kGapOpen, f - kGapExtend);
    const int hv = max(tmp, f);
    diag = w.h;
    w.h = hv;
    w.e = ev;
    hu = hv;
    cm = max(cm, hv);
  }
};

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
struct CellI32Dpx {
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
  __device__ __forceinline__ static int carry_in(int g) { return g; }
  __device__ __forceinline__ static int carry_out(int gu) { return gu; }

  // As CellI32::step with every H word in G form: diag is G(r-1, j-1) on
  // entry and G(r, j-1) on exit, gu G(r-1, j) -> G(r, j); cm takes H.
  __device__ __forceinline__ static void step(Row& w, uint2 t, int& diag,
                                              int& gu, int& f, int& cm) {
    int s;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(s) : "r"(t.x), "r"(t.y),
        "r"(w.sel));
    const int ev = __viaddmax_s32(w.e, -kGapExtend, w.g);
    const int tmp = __viaddmax_s32_relu(diag, s, ev);
    f = __viaddmax_s32(f, -kGapExtend, gu);
    const int hv = max(tmp, f);
    diag = w.g;
    w.g = hv - kGapOpen;
    w.e = ev;
    gu = w.g;
    cm = max(cm, hv);
  }
};

// Two int16 cells per 32-bit register, row A in the low half and row B in
// the high half, with Hopper's s16x2 DPX forms.  Exact while every H fits
// in int16 (the caller's gate: H <= 5 * min(m16, N) <= 30000); E and F stay
// >= -20 after the first row and the F sentinel above row 0 is -16384.
//
// A code is a prmt selector: the column's two engine codes (< 8), each
// with a sign-replicating copy, so prmt of a row's 8-entry int8 score
// table (lo, hi words) gives both halves' sign-extended scores in one op.
// H - 16 is kept per row (h16) and handed down as `hu`, so each gap costs
// one __viaddmax: 7 operations per two cells.
template <bool kThresh>
struct CellS16x2 {
  using Word = unsigned;
  using Code = uint16_t;
  struct Row {
    unsigned h, h16, e, tlo, thi;
  };
  static constexpr unsigned kTop = 0xC000C000u;  // -16384 in both halves
  static constexpr unsigned kMin = 0x80008000u;  // -32768: max(x, kMin) = x
  static constexpr unsigned kM4 = 0xFFFCFFFCu;   // -4
  static constexpr unsigned kM16 = 0xFFF0FFF0u;  // -16
  static constexpr unsigned kP16 = 0x00100010u;  // +16

  static __host__ __device__ constexpr uint16_t selector(int ca, int cb) {
    return static_cast<uint16_t>(ca | (ca | 8) << 4 | cb << 8 |
                                 (cb | 8) << 12);
  }
  __device__ __forceinline__ static Row row(QueryRow qr) {
    unsigned t[2] = {0, 0};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int sc = c == qr.q ? qr.hi : qr.lo;
      if (kThresh && c == 5) sc = qr.nv;
      t[c / 4] |= (static_cast<unsigned>(sc) & 0xffu) << (8 * (c % 4));
    }
    return Row{0, kM16, 0, t[0], t[1]};
  }
  __device__ __forceinline__ static unsigned carry_in(unsigned h) {
    return __viaddmax_s16x2(h, kM16, kMin);
  }
  __device__ __forceinline__ static unsigned carry_out(unsigned hu) {
    return __viaddmax_s16x2(hu, kP16, kMin);
  }

  // As CellI32::step, with hu holding H(., j) - 16.
  __device__ __forceinline__ static void step(Row& w, unsigned sel,
                                              unsigned& diag, unsigned& hu,
                                              unsigned& f, unsigned& cm) {
    unsigned sc;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(sc) : "r"(w.tlo), "r"(w.thi),
        "r"(sel));
    const unsigned ev = __viaddmax_s16x2(w.e, kM4, w.h16);
    const unsigned tmp = __viaddmax_s16x2_relu(diag, sc, ev);
    f = __viaddmax_s16x2(f, kM4, hu);
    const unsigned hv = __vimax_s16x2_relu(tmp, f);
    diag = w.h;
    w.h = hv;
    w.e = ev;
    w.h16 = __viaddmax_s16x2(hv, kM16, kMin);
    hu = w.h16;
    cm = __vimax_s16x2_relu(cm, hv);
  }
};

// Strips and rows per lane of a query of m16 rows: the rows spread evenly
// over the strips, so that the last one is not mostly idle.
__host__ __device__ inline int sweep_strips(int m16) {
  return (m16 + kWarp * kMaxRows - 1) / (kWarp * kMaxRows);
}
__host__ __device__ inline int sweep_rows(int m16) {
  const int nstrips = sweep_strips(m16);
  return (m16 + kWarp * nstrips - 1) / (kWarp * nstrips);
}

// codes: the row's N codes (shared memory, written before the call and
// followed by a __syncwarp); load(row) -> QueryRow for rows < m16; bnd:
// Word[3, N] scratch (read only with more than one strip); emit(j, cm)
// runs on lane 31 for every column j in order.
template <class Cell, class Load, class Emit>
__device__ __forceinline__ void sweep_columns(const typename Cell::Code* codes,
                                              int N, int m16,
                                              typename Cell::Word* bnd,
                                              Load load, Emit emit) {
  using Word = typename Cell::Word;
  const int lane = threadIdx.x % kWarp;
  const int nstrips = sweep_strips(m16);
  const int rpt = sweep_rows(m16);
  Word* bh = bnd;  // used only with >1 strip
  Word* bf = bh + N;
  Word* bc = bf + N;
  for (int strip = 0; strip < nstrips; ++strip) {
    const int row0 = (strip * kWarp + lane) * rpt;
    const int nr = max(0, min(rpt, m16 - row0));
    typename Cell::Row w[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      w[r] = Cell::row(r < nr ? load(row0 + r) : QueryRow{-1, 0, 0, 0});
    const bool first = strip == 0;
    const bool last = strip == nstrips - 1;
    Word up_prev = 0;  // H of the row above the band at the previous column
    Word out_h = 0, out_f = Cell::kTop, out_c = 0;
    for (int step = 0; step < N + kWarp - 1; ++step) {
      Word in_h = __shfl_up_sync(kFull, out_h, 1);
      Word in_f = __shfl_up_sync(kFull, out_f, 1);
      Word in_c = __shfl_up_sync(kFull, out_c, 1);
      const int j = step - lane;
      if (j >= 0 && j < N) {
        if (lane == 0) {
          if (first) {
            in_h = 0;
            in_f = Cell::kTop;
            in_c = 0;
          } else {
            in_h = bh[j];
            in_f = bf[j];
            in_c = bc[j];
          }
        }
        const Word c = codes[j];
        Word diag = up_prev;
        up_prev = in_h;
        Word hu = Cell::carry_in(in_h), f = in_f, cm = in_c;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nr) Cell::step(w[r], c, diag, hu, f, cm);
        }
        out_h = Cell::carry_out(hu);
        out_f = f;
        out_c = cm;
        if (lane == kWarp - 1) {
          if (last) {
            emit(j, cm);
          } else {
            bh[j] = out_h;
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
}

// K1's sweep: sweep_columns' wavefront with every lane stepping exactly
// kRows == sweep_rows(m16) rows (the caller dispatches on it), so the row
// loop is straight code.  The rows the strips hold beyond m16 go above row
// 0 as rows of Cell::zero_query(), which score 0: such a row keeps H = 0
// under a top boundary of H = 0 (diag + 0, E and F <= 0) and hands row 0
// F = -16, which it gets from H(-1, j) = 0 anyway, so the DP and every
// column max are unchanged.  The strip hand-off goes through the global
// scratch row in blocks of 32 columns, one column a lane, staged in
// shared memory: lane 0 reads the row above the strip from the staging
// block (the next block is fetched 32 steps ahead), lane 31 writes its
// outputs into the other staging block, and every 32 columns the warp
// stores that block, so no step branches on the lane.
//
// col(j): column j's word for Cell::step (a call after the caller's codes
// are written and a __syncwarp); load(row) -> the argument of Cell::row
// for rows < m16;
// bnd: Word[3, N] scratch (read only with more than one strip); emit(j,
// cm) runs on lane j % 32 for every column j, 32 columns at a time.
template <class Cell, int kRows, class Col, class Load, class Emit>
__device__ __forceinline__ void sweep_columns_fixed(
    Col col, int N, int m16, typename Cell::Word* bnd, Load load,
    Emit emit) {
  using Word = typename Cell::Word;
  __shared__ Word stage_in[3][kWarp];   // H, F, column max above the strip
  __shared__ Word stage_out[3][kWarp];  // lane 31's H, F, column max
  const int lane = threadIdx.x % kWarp;
  const int nstrips = sweep_strips(m16);
  const int pad = nstrips * kWarp * kRows - m16;  // zero rows above row 0
  Word* bh = bnd;  // used only with >1 strip
  Word* bf = bh + N;
  Word* bc = bf + N;
  for (int strip = 0; strip < nstrips; ++strip) {
    const int row0 = (strip * kWarp + lane) * kRows - pad;
    typename Cell::Row w[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      w[r] = Cell::row(row0 + r >= 0 ? load(row0 + r) : Cell::zero_query());
    const bool first = strip == 0;
    const bool last = strip == nstrips - 1;
    Word up_prev = Cell::kH0;  // H of the row above the band, last column
    Word out_h = Cell::kH0, out_f = Cell::kTop, out_c = 0;
    // the scratch row's next block, column 32 * block + lane
    Word next_h = Cell::kH0, next_f = Cell::kTop, next_c = 0;
    if (!first && lane < N) {
      next_h = bh[lane];
      next_f = bf[lane];
      next_c = bc[lane];
    }
    for (int step = 0; step < N + kWarp - 1; ++step) {
      const int k = step % kWarp;
      if (!first && k == 0) {
        __syncwarp();
        stage_in[0][lane] = next_h;
        stage_in[1][lane] = next_f;
        stage_in[2][lane] = next_c;
        const int jn = step + kWarp + lane;
        if (jn < N) {
          next_h = bh[jn];
          next_f = bf[jn];
          next_c = bc[jn];
        }
        __syncwarp();
      }
      Word in_h = __shfl_up_sync(kFull, out_h, 1);
      Word in_f = __shfl_up_sync(kFull, out_f, 1);
      Word in_c = __shfl_up_sync(kFull, out_c, 1);
      if (lane == 0) {  // column step: the top boundary or the strip above
        in_h = first ? Cell::kH0 : stage_in[0][k];
        in_f = first ? Cell::kTop : stage_in[1][k];
        in_c = first ? 0 : stage_in[2][k];
      }
      const int j = step - lane;
      if (j >= 0 && j < N) {
        const auto c = col(j);
        Word diag = up_prev;
        up_prev = in_h;
        Word hu = Cell::carry_in(in_h), f = in_f, cm = in_c;
#pragma unroll
        for (int r = 0; r < kRows; ++r) Cell::step(w[r], c, diag, hu, f, cm);
        out_h = Cell::carry_out(hu);
        out_f = f;
        out_c = cm;
      }
      const int j31 = step - (kWarp - 1);  // lane 31's column
      if (j31 >= 0) {
        if (lane == kWarp - 1) {
          stage_out[0][j31 % kWarp] = out_h;
          stage_out[1][j31 % kWarp] = out_f;
          stage_out[2][j31 % kWarp] = out_c;
        }
        if (j31 % kWarp == kWarp - 1 || j31 == N - 1) {
          __syncwarp();
          const int jb = j31 - j31 % kWarp + lane;
          if (jb <= j31) {
            if (last) {
              emit(jb, stage_out[2][lane]);
            } else {
              bh[jb] = stage_out[0][lane];
              bf[jb] = stage_out[1][lane];
              bc[jb] = stage_out[2][lane];
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace fasim
