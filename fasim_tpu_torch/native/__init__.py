"""ctypes loaders for the native runtime (built on demand).

Copy of fasim_tpu/native for the port.  `g++` builds this package's own
sources into `build/native/libfasim_torch_native.so` beside the package
at first use (rebuilt when a source is newer), so a process can load this
library and the JAX package's side by side.  The JAX package's
`lt_fastsim_segment` is not copied: the port's drivers do not call it.
`lt_sim_replay` (`sim_scan_replay`) replays the qualifying cells of the
device SIM forward scan (kernels/sim_dev.py) through the host node list."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..profiling import STAGES

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
_SO = os.path.join(BUILD_DIR, "libfasim_torch_native.so")
_SRCS = [os.path.join(_DIR, f) for f in
         ("lt_sort.cpp", "ssw_align.cpp", "sim_exact.cpp",
          "fastsim_stage.cpp")]
_HDRS = [os.path.join(_DIR, "align_core.h")]

_lib = None


_load_lock = threading.Lock()


def _load():
    """Build (if stale) and load the unified native runtime library.
    Thread-safe: the library handle is published only after every
    function's argtypes are configured (worker threads call this)."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        deps = _SRCS + _HDRS
        if (not os.path.exists(_SO) or os.path.getmtime(_SO) <
                max(os.path.getmtime(s) for s in deps)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = _SO + f".tmp{os.getpid()}"
            with STAGES.timer("build"):
                subprocess.run(["g++", "-O3", "-mavx2", "-funroll-loops",
                                "-fPIC", "-shared", *_SRCS, "-o", tmp],
                               check=True, capture_output=True)
            os.replace(tmp, _SO)  # atomic vs concurrent builds
        lib = ctypes.CDLL(_SO)
        c = ctypes
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.lt_fastsim_dedup.restype = c.c_int32
        lib.lt_fastsim_dedup.argtypes = [i32p, i32p, i32p, i32p, f32p,
                                          c.c_int32, i32p]
        lib.lt_sort_by_motif.restype = None
        lib.lt_sort_by_motif.argtypes = [i32p, c.c_int32, i32p]
        lib.lt_sim_scan.restype = c.c_long
        lib.lt_sim_scan.argtypes = [
            c.c_char_p, c.c_long, c.c_char_p, c.c_long, c.c_char_p,
            c.c_long, c.c_long, c.c_long, c.c_long, c.c_long, c.c_long,
            c.c_long, c.c_long, c.c_long, i32p, f32p, i64p, c.c_char_p,
            c.c_long]
        lib.lt_sim_replay.restype = c.c_long
        lib.lt_sim_replay.argtypes = [
            c.c_char_p, c.c_long, c.c_char_p, c.c_long, c.c_char_p,
            c.c_long, c.c_long, c.c_long, c.c_long, c.c_long, c.c_long,
            c.c_long, c.c_long, i32p, c.c_long, c.c_long, i32p, f32p,
            i64p, c.c_char_p, c.c_long]
        lib.lt_ssw_align.restype = c.c_long
        lib.lt_ssw_align.argtypes = [
            i32p, c.c_long, i32p, c.c_long, i32p, c.c_long, c.c_long,
            c.c_long, i32p, i32p, c.c_char_p, c.c_long]
        lib.lt_fastsim_pair.restype = c.c_long
        lib.lt_fastsim_pair.argtypes = [
            i32p, c.c_long, i32p, c.c_long, c.c_char_p, c.c_char_p,
            c.c_char_p, i32p, i32p, c.c_long, c.c_long, c.c_long, c.c_long,
            c.c_long, c.c_long, c.c_long, c.c_long, c.c_long, c.c_long,
            c.c_long, c.c_float, c.c_float, c.c_long, i32p, f32p, i64p,
            c.c_char_p, c.c_long]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.lt_segment_peaks.restype = c.c_long
        lib.lt_segment_peaks.argtypes = [u8p, c.c_long, i32p, c.c_long,
                                         c.c_long, i32p, c.c_long]
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        lib.lt_segment_peaks_packed.restype = c.c_long
        lib.lt_segment_peaks_packed.argtypes = [i16p, u8p, i32p, c.c_long,
                                                c.c_long, i32p, c.c_long]
        lib.lt_finalize_pair.restype = c.c_long
        lib.lt_finalize_pair.argtypes = [
            i32p, c.c_long, i32p, c.c_long, c.c_char_p, c.c_char_p,
            c.c_char_p, i32p, c.c_long, i32p, c.c_long, c.c_long, c.c_long,
            c.c_long, c.c_long, c.c_long, c.c_long, c.c_long, c.c_long,
            c.c_long, c.c_float, c.c_float, c.c_long, i32p, f32p, i64p,
            c.c_char_p, c.c_long]
        _lib = lib
    return _lib


_load_sim = _load
_load_ssw = _load


def fastsim_pair(q_idx: np.ndarray, r_idx: np.ndarray, rna: bytes,
                 seq2: bytes, src: bytes, colmax: np.ndarray,
                 mat: np.ndarray, go: int, ge: int, dna_start_pos: int,
                 min_score: int, strand: int, para: int, nt_min: int,
                 nt_max: int, penalty_t: int, penalty_c: int,
                 min_identity: float, min_stability: float) -> list[tuple]:
    """Full fastSIM candidate stage (fastsim.h:158-289) for one
    (segment, transform) pair: peaks -> Iden sweep -> realign -> convert ->
    dedup -> top-50 -> filter.  Returns tuples (stari, endi, starj, endj,
    nt, score, identity, tri_score, stri_align, strj_align).  Thread-safe;
    releases the GIL for the native call."""
    lib = _load()
    cap = 64
    strbuf_cap = 1 << 20
    ints = np.empty(cap * 6, np.int32)
    floats = np.empty(cap * 3, np.float32)
    stroffs = np.empty(cap * 4, np.int64)
    strbuf = ctypes.create_string_buffer(strbuf_cap)
    n = lib.lt_fastsim_pair(
        q_idx, len(q_idx), r_idx, len(r_idx), rna, seq2, src, colmax,
        mat, mat.shape[1], go, ge, dna_start_pos, min_score, strand, para,
        nt_min, nt_max, penalty_t, penalty_c, min_identity, min_stability,
        cap, ints, floats, stroffs, strbuf, strbuf_cap)
    if n < 0:
        raise RuntimeError("fastsim_pair output buffer overflow")
    out = []
    raw = strbuf.raw
    for k in range(n):
        io, il, jo, jl = stroffs[4 * k: 4 * k + 4]
        out.append((int(ints[6 * k]), int(ints[6 * k + 1]),
                    int(ints[6 * k + 2]), int(ints[6 * k + 3]),
                    int(ints[6 * k + 4]), floats[3 * k],
                    floats[3 * k + 1], floats[3 * k + 2],
                    raw[io:io + il].decode(), raw[jo:jo + jl].decode()))
    return out


def ssw_align(query_idx: np.ndarray, ref_idx: np.ndarray, mat: np.ndarray,
              go: int, ge: int):
    """Exact ssw_align emulation (sswNew.cpp:1446-1547).  Returns
    (sw_score, ref_begin, ref_end, query_begin, query_end, cigar) where
    cigar is a list of (length, op) tuples; sw_score 0 means no/failed
    alignment (caller discards)."""
    lib = _load_ssw()
    cap = len(query_idx) + len(ref_idx) + 8
    meta = np.empty(5, np.int32)
    cig_len = np.empty(cap, np.int32)
    cig_op = ctypes.create_string_buffer(cap)
    n = lib.lt_ssw_align(
        np.ascontiguousarray(query_idx, np.int32), len(query_idx),
        np.ascontiguousarray(ref_idx, np.int32), len(ref_idx),
        np.ascontiguousarray(mat, np.int32), mat.shape[1], go, ge,
        meta, cig_len, cig_op, cap)
    if n < 0:
        raise RuntimeError("ssw_align cigar buffer overflow")
    if meta[0] == 0:
        return 0, -1, -1, -1, -1, []
    ops = cig_op.raw[:n].decode()
    return (int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3]),
            int(meta[4]), [(int(cig_len[k]), ops[k]) for k in range(n)])


def sim_scan(rna: bytes, dna_t: bytes, src: bytes, dna_start_pos: int,
             min_score: int, strand: int, para: int, nt_min: int,
             nt_max: int, penalty_t: int, penalty_c: int) -> list[tuple]:
    """Exact SIM engine (sim.h:410-1143) on one (query, transformed,
    source) triple.  Returns tuples (stari, endi, starj, endj, nt, score,
    identity, tri_score, stri_align, strj_align)."""
    lib = _load_sim()
    cap = 64
    strbuf_cap = 1 << 22
    ints = np.empty(cap * 5, np.int32)
    floats = np.empty(cap * 3, np.float32)
    stroffs = np.empty(cap * 4, np.int64)
    strbuf = ctypes.create_string_buffer(strbuf_cap)
    n = lib.lt_sim_scan(rna, len(rna), dna_t, len(dna_t), src,
                        dna_start_pos, min_score, strand, para, nt_min,
                        nt_max, penalty_t, penalty_c, cap, ints, floats,
                        stroffs, strbuf, strbuf_cap)
    if n < 0:
        raise RuntimeError("sim_scan output buffer overflow")
    return _sim_rows(n, ints, floats, stroffs, strbuf)


def _sim_rows(n, ints, floats, stroffs, strbuf):
    out = []
    raw = strbuf.raw
    for k in range(n):
        io, il, jo, jl = stroffs[4 * k: 4 * k + 4]
        out.append((int(ints[5 * k]), int(ints[5 * k + 1]),
                    int(ints[5 * k + 2]), int(ints[5 * k + 3]),
                    int(ints[5 * k + 4]), floats[3 * k],
                    floats[3 * k + 1], floats[3 * k + 2],
                    raw[io:io + il].decode(), raw[jo:jo + jl].decode()))
    return out


def sim_scan_replay(rna: bytes, dna_t: bytes, src: bytes,
                    dna_start_pos: int, min_score: int, strand: int,
                    para: int, nt_min: int, nt_max: int, penalty_t: int,
                    penalty_c: int, cells: np.ndarray) -> list[tuple]:
    """sim_scan with the forward scan replaced by a device-computed
    qualifying-cell stream (kernels/sim_dev.py): cells int32[n, 5] =
    (c, ci, cj, i, j) in scan order.  Output contract == sim_scan."""
    lib = _load_sim()
    cap = 64
    strbuf_cap = 1 << 22
    ints = np.empty(cap * 5, np.int32)
    floats = np.empty(cap * 3, np.float32)
    stroffs = np.empty(cap * 4, np.int64)
    strbuf = ctypes.create_string_buffer(strbuf_cap)
    cells = np.ascontiguousarray(cells.reshape(-1), np.int32)
    n = lib.lt_sim_replay(rna, len(rna), dna_t, len(dna_t), src,
                          dna_start_pos, min_score, strand, para, nt_min,
                          nt_max, penalty_t, penalty_c, cells,
                          len(cells) // 5, cap, ints, floats, stroffs,
                          strbuf, strbuf_cap)
    if n < 0:
        raise RuntimeError("sim_scan_replay output buffer overflow")
    return _sim_rows(n, ints, floats, stroffs, strbuf)


def segment_peaks(cm_u8: np.ndarray, cm_stride: int, thresh: np.ndarray,
                  n: int) -> np.ndarray:
    """Byte-break + preAlign peak clustering for all scans of one segment
    (prefix of the candidate stage).  cm_u8: uint8[K, stride]; thresh:
    int32[K]; n = real segment length.  Returns int32[npeaks, 3] rows
    (scan_idx, score, position) in scan-major order.  Releases the GIL."""
    lib = _load()
    nscans = len(thresh)
    cap = nscans * (n // 2 + 8)
    out = np.empty(cap * 3, np.int32)
    m = lib.lt_segment_peaks(
        np.ascontiguousarray(cm_u8, np.uint8), cm_stride,
        np.ascontiguousarray(thresh, np.int32), nscans, n, out, cap)
    if m < 0:
        raise RuntimeError("segment_peaks output buffer overflow")
    return out[:m * 3].reshape(m, 3).copy()


def segment_peaks_packed(pos: np.ndarray, val: np.ndarray,
                         cnt: np.ndarray) -> np.ndarray:
    """Peaks from device-packed candidates for one segment (no scan may
    overflow — caller routes cnt > K scans through segment_peaks).
    pos int16[K_scans, K]; val uint8[..]; cnt int32[K_scans].  Returns
    int32[npeaks, 3] (scan_idx, score, position).  Releases the GIL."""
    lib = _load()
    nscans, K = pos.shape
    cap = int(cnt.sum()) + 8
    out = np.empty(cap * 3, np.int32)
    m = lib.lt_segment_peaks_packed(
        np.ascontiguousarray(pos, np.int16),
        np.ascontiguousarray(val, np.uint8),
        np.ascontiguousarray(cnt, np.int32), nscans, K, out, cap)
    if m < 0:
        raise RuntimeError("segment_peaks_packed output buffer overflow")
    return out[:m * 3].reshape(m, 3).copy()


def finalize_pair(q_idx: np.ndarray, r_idx: np.ndarray, rna: bytes,
                  s2: bytes, src: bytes, wins: np.ndarray, mat: np.ndarray,
                  go: int, ge: int, dna_start_pos: int, strand: int,
                  para: int, nt_min: int, nt_max: int, penalty_t: int,
                  penalty_c: int, min_identity: float,
                  min_stability: float) -> list[tuple] | None:
    """Tail of the candidate stage for one pair after the device window
    passes: banded traceback + convert + dedup/top-50/filter.  wins:
    int32[nw, 5] = (score, ref_begin, ref_end, query_begin, query_end),
    segment-absolute.  Returns result tuples like fastsim_pair, or None on
    a banded traceback error (caller falls back to the sequential path).
    Releases the GIL."""
    lib = _load()
    cap = 64
    strbuf_cap = 1 << 20
    ints = np.empty(cap * 6, np.int32)
    floats = np.empty(cap * 3, np.float32)
    stroffs = np.empty(cap * 4, np.int64)
    strbuf = ctypes.create_string_buffer(strbuf_cap)
    n = lib.lt_finalize_pair(
        q_idx, len(q_idx), r_idx, len(r_idx), rna, s2, src,
        np.ascontiguousarray(wins, np.int32), len(wins), mat, mat.shape[1],
        go, ge, dna_start_pos, strand, para, nt_min, nt_max, penalty_t,
        penalty_c, min_identity, min_stability, cap, ints, floats, stroffs,
        strbuf, strbuf_cap)
    if n == -3:
        return None
    if n < 0:
        raise RuntimeError("finalize_pair output buffer overflow")
    out = []
    raw = strbuf.raw
    for k in range(n):
        io, il, jo, jl = stroffs[4 * k: 4 * k + 4]
        out.append((int(ints[6 * k]), int(ints[6 * k + 1]),
                    int(ints[6 * k + 2]), int(ints[6 * k + 3]),
                    int(ints[6 * k + 4]), floats[3 * k],
                    floats[3 * k + 1], floats[3 * k + 2],
                    raw[io:io + il].decode(), raw[jo:jo + jl].decode()))
    return out


def fastsim_dedup(stari, endi, starj, endj, score) -> np.ndarray:
    """Surviving original indices, in final order, of the fastSIM dedup
    chain (fastsim.h:273-283) with libstdc++-identical tie-breaking."""
    lib = _load()
    n = len(stari)
    out = np.empty(max(n, 1), dtype=np.int32)
    m = lib.lt_fastsim_dedup(
        np.ascontiguousarray(stari, np.int32),
        np.ascontiguousarray(endi, np.int32),
        np.ascontiguousarray(starj, np.int32),
        np.ascontiguousarray(endj, np.int32),
        np.ascontiguousarray(score, np.float32), n, out)
    return out[:m].copy()


def sort_by_motif(motif) -> np.ndarray:
    """Permutation applied by printResult's std::sort-by-class
    (Fasim-LongTarget.cpp:813) with libstdc++-identical tie-breaking."""
    lib = _load()
    n = len(motif)
    out = np.empty(max(n, 1), dtype=np.int32)
    lib.lt_sort_by_motif(np.ascontiguousarray(motif, np.int32), n, out)
    return out[:n].copy()
