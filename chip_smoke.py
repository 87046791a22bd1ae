#!/usr/bin/env python3
"""Smoke run of the fasim_tpu_torch main path on one CUDA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

  1. device  — requires torch.cuda.is_available(); prints the card's name
     and power limit (nvidia-smi), torch's and CUDA's versions;
  2. build   — compiles fasim_tpu_torch/csrc/*.cu with nvcc;
  3. kernels — every kernel against its plain PyTorch version on the card,
     exact integer equality, on inputs made with numpy default_rng: K1
     scan_colmax and K7 scan_colmax16 (main-path batch, ragged,
     byte-saturating GA-rich, impure with a U query, strip edges at
     m16 = 512, 528 and 1,040, a NEAT1-length query, K7's gate edge
     (GA repeats at m = N = 6,000, 5 * min(m16, N) = 30,000, where K7's
     largest per-pair max must reach 25,000), a 50 kb segment; K7
     against its own plain version on the main-path batch, the NEAT1-
     length query and the gate edge, against K1's on the others), all in
     both alphabets,
     the engine's K7/K1 routing under FASIM_SCAN16=1 (odd T, out of the
     int16 gate, the full-prefix rerun), the candidate packing against
     its numpy mirror, K3 window_fwd on every width class (rlens of 32
     columns and fewer included), on a NEAT1-length query and on the
     specs of a real candidate stage, K4 window_general (16-bit row
     keys) and window_general_long (its long form, the keys folded by
     chunks of 65,536 rows) on every width class with random offs, terms
     and mreals, pairs of shared and of mismatched offsets, at MEG3, NEAT1
     and the 91 kb query's length (there the long form only, beside K6's),
     and on the real forward and reverse specs, the engine's gates (at m =
     K3_MAX_M uniform forward specs on K3 and reverse specs on
     window_general, one row past it both on window_general_long), K6
     window_v1 and its long form window_v1_long against their plain chain
     on the same cases as K4 (at NEAT1 length the 64-column ones; at 91
     kb against K4's plain version) and on K3's width classes, and at
     K6's gate (query rows K6_MAX_NQ on window_v1, 65,664 with largest
     mreals 65,536 and 65,537 on window_v1_long, against K4's plain
     version), K5 scan_codes_colmax on its
     library's launch plan and at the plan's edges (one strip, strips =
     warps, strips > warps through the scratch row, one warp over several
     strips) with codes >= 8 in the rows, in both alphabets (the
     per-segment shape, a short query, a packed batch, impure codes with a
     U query, a GA-rich row past 251, a NEAT1-length query, rows of 5 and
     40 columns) and the engine's per-segment call on the card against
     the same call on a CPU engine; K8 sim_forward (cs and ct) on random
     pairs (T = 3), planted homology (10% mutated), a run of N, a query
     with non-ACGT bytes, m in {1, 7, 8, 31, 32, 33}, every rows-a-lane
     instantiation at its strip edges, and at the column edges N in {1,
     31, 32, 33, 63, 64, 65} with m at strip edges, h19_F's group (H19 x
     testDNA's segment, T = 2) and a NEAT1-length pair (N = 5,000), and
     sim_forward_cells on h19_F's group at K1's thresholds against the
     numpy mirror of the JAX package's host compaction;
  4. e2e     — in this process, every output file and stdout (except
     "Running time is") byte for byte against oracle/golden, each run
     with the launch counts set to 0 just before it and read just after,
     the kernels of its path launched and the kernels its switches turn
     off not launched, and prewarm's own launch count printed: h19_lg40,
     h19_default and h19F_trunc (-F) through the port's CLI, h19_lg40
     under FASIM_PREWARM=0 (the default run's launch counts), the flag
     cases flags_r3_t1 (-r 3 -t 1: T = 2), also under FASIM_SCAN16=1
     FASIM_WIN_V1=1 (K7, K6), and flags_c2000 (-c 2000 -o 50) against
     the JAX package's outputs in oracle/jax_expected, h19_lg40 under
     FASIM_WIN_V3=0 (K4 for
     the forward specs, no K3), h19_lg40 through the batched driver with
     TorchScanEngine(use_v2=False) (K5), meg3_sub16 through the
     per-segment path scan/pipeline.scan_file (K5), neat1 (NEAT1,
     22,767 nt), malat1 (MALAT1, 8,708 nt) and meg3_sub64 through the
     CLI (K1, K3, K4), meg3_full (MEG3 lncRNA x 1.32 Mb, 532 records)
     through the CLI under FASIM_SCAN16=1 FASIM_WIN_V1=1 (K7, K6's
     window_v1; no K1, K3 or K4), then meg3_full (K1, K3, K4) and
     h19F_trunc (-F, K1) through the streaming driver (--tpu-stream on,
     FASIM_SPILL_DIR a fresh directory that must be empty after the
     run), h19F_trunc and h19_F under FASIM_SIM_DEVICE=1 (batched; K1
     and K8) and h19_F under --tpu-sim-device true --tpu-stream on (K1
     and K8), with the -F walls printed; each CLI run must go
     through the driver its flags pick; no run launches the long forms
     window_general_long and window_v1_long, and no run without the
     switch launches K8;
  5. multi   — multi-GPU and multi-host: MEG3-full through the
     batched driver's round-robin over two engines (cuda:0 and
     cuda:1 where device_count() >= 2, both on cuda:0 otherwise) and
     meg3_sub64 through the CLI under --tpu-dp-devices 2 (min(2,
     device_count()) engines), h19F_trunc (-F, FASIM_SIM_DEVICE=1) over
     two engines, each
     byte-identical with the kernels of its path launched (K1, K3, K4;
     K1, K8) and engine i dispatching batches i, i + n, ... of the run
     (counted by wrapping the engines' dispatch, not by the global launch
     counts); MEG3-full through two `python -m fasim_tpu_torch.dist.runner
     --tpu-engine cuda` processes (rank r on card r mod device_count()
     through CUDA_VISIBLE_DEVICES, gloo over loopback, a fresh
     FASIM_CKPT): rank 0's files byte-identical, K1, K3 and K4 launched
     in each rank, then the outputs wiped and the run repeated from the
     checkpoint spills: the same bytes with no kernel launched; each
     rank's local and gather seconds are printed; and
     dist.dryrun.dryrun_multichip on the two devices (K1, K5 and K3
     launched);
  6. genome  — a synthetic genome (GENOME_MB = 34 Mb of random ACGT in
     5 Mb records with planted MEG3 homologies, about 34.4 MB, past the
     CLI's 32 MiB --tpu-stream auto threshold) with MEG3 through the CLI
     in its own process under auto (the streaming driver), and a smaller
     one from the same generator (SMALL_GENOME_MB = 5.5 Mb, seed 0, two
     records) under --tpu-stream on and off (the batched driver), each in
     its own process; every run launches K1, K3 and K4 and not the
     long-query kernels, leaves no spill file and writes TFOsorted rows,
     and on and off write byte-identical output files and stdout; each
     run's wall, Mb/s, stage split (FASIM_PROFILE) and peak RSS (ru_maxrss
     of its process) are printed before the last lines;
  7. times   — each kernel and its plain version at main-path shapes
     (CUDA events around synchronized runs; K1's ssw pass with its G
     cells/s, the SASS count of its step loop a cell (sass_loop), the
     integer ops/s that loop executes, the count of its column block
     alone, its resident warps an SM and waves, then
     K1's threshold pass; K7 at K1's shape with the same counts (its
     rows a lane, the SASS of its step loop a cell, its resident warps
     and waves) and its threshold pass; K1 and K7 at NEAT1 length on
     the full batch (kernel only) with their bound and the int32 floor;
     K6 (window_v1 beside K4's window_general, and its long form
     window_v1_long called directly) on K3's forward and K4's reverse
     dispatch, and the ptxas registers of K4's and K6's pair kernels in
     both forms; on K3's dispatch also K4 and its long form on those
     specs, and the dispatch's rlen histogram; on K4's dispatch K4's long
     form called directly, each width class's time, bound and swept cells,
     the histograms of the sweep spans and of the offset mismatches
     within pairs; K5 at the per-segment shape in both alphabets on its
     plan and on the candidate plans, the cycles of its step against its
     rows a lane, at the packed-batch shape and on the per-segment rows
     at NEAT1 length, with each launched instantiation's step-loop SASS,
     registers and resident warps an SM; K8 at h19_F's group and at
     NEAT1 length by rows a lane, the fit of its time (a lag a strip and
     a cost a step by rows a lane), its registers and shared memory a
     block, its launches a run, and sim_forward_cells on h19_F's group
     piece by piece (its own `times`: encoding and copy in, K8, the
     compare, count and nonzero, the gathers and stack, the copy to the
     host, the numpy split),
     each kernel's bound: the larger of the least integer operations its
     cells need (scan_ops_per_cell, WINDOW_OPS_PER_CELL,
     SIM_OPS_PER_CELL) over the card's int32 rate (SMs x 64 lanes x the
     max SM clock) and its bytes over 3.35 TB/s, and every kernel's
     ptxas registers;
  8. trace   — the default meg3_full run through the CLI (K1, K3, K4;
     checked as phase 4 checks its runs, and the main path whose counts
     the report gives) under torch.profiler: the device time by kernel
     and copy, and their sum against the wall; it fails if the profiler
     records no device event;
  9. long    — the long query (long_query(): oracle/NEAT1.fa's lncRNA
     four times, 5% of each copy's bases replaced from seed 0, 91,068
     nt, about KCNQ1OT1's length) x testDNA (one segment, one batch)
     through the CLI, default and under FASIM_WIN_V1=1: K1 (and K7) at
     that length on testDNA's segment against the plain version; each run
     launches K1 and, in every window pass, its long form
     (window_general_long; window_v1_long) and no other window kernel;
     every window dispatch of the run is recorded and its ends held
     against the plain version on a seeded subset of each width class
     (LONG_HELD rows) and every row whose offset or mreal passes 65,536;
     both runs write the same files and stdout, with TFOsorted rows; then
     both long forms on the run's largest forward and reverse dispatch
     with their bounds and shares (the kernels line's times and bounds
     of the long forms; their launches are the runs').

Then the walls of phases 4, 5, 6, 8 and 9 with the card's name and power limit,
the card's line, one JSON line of per-kernel results and, last, the line
{"ok": true, "device": {...}}.  Any failure exits non-zero without it;
so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(REPO, "oracle")
SEED = 20261016
MEG3_M = 1582  # the MEG3 lncRNA of oracle/MEG3.fa
NEAT1_M = 22767  # the NEAT1 lncRNA of oracle/NEAT1.fa
MEM_BPS = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA's data sheet)
INT32_LANES = 64  # INT32 units per SM (Hopper)


def scan_ops_per_cell(m16: int, N: int) -> float:
    """The least integer operations one DP cell of a scan (K1, K5, K7)
    needs on sm_90 at query length m16 against N segment columns, each
    counted at the INT32 rate (fewer than the kernels execute).

    The recurrence takes 7: the score 1 (one PRMT of a per-row byte table
    by the column's code gives the sign-extended score in either
    alphabet), H - 16 once for both gaps 1, E and F one __viaddmax each,
    H 2 (__viaddmax_relu of diag + s and E, then max with F), the column
    max 1.  Where every H fits in 16 bits the two-lane s16x2 forms do two
    cells per operation: 3.5.  A local score is at most 5 a column and 5 a
    row, 5 * min(m16, N) (the bound K7's gate reads), so a scan takes 3.5
    while that is <= 32767."""
    return 7 / 2 if 5 * min(m16, N) <= 32767 else 7


# The least integer operations one DP cell of a window kernel (K3, K4,
# K6) needs on sm_90, counted as scan_ops_per_cell counts.  A window's H
# is at most 5 * min(m, 256) <= 1,280 at any query length, so the window
# kernels always take the s16x2 forms (6 / 2), and they need no separate
# column max: each column's (max, lowest row) is one max over a 32-bit key
# (H << 16) | (0xFFFF - row) built by one PRMT, 2 a cell (on the phantom
# rows m..m16-1 a packed max alone, fewer).
WINDOW_OPS_PER_CELL = 6 / 2 + 2


class ScanKernel(NamedTuple):
    """What Smoke.scan_rates reads of a scan kernel: its name in the
    output, its entry's mangled-name prefix (the template argument, rows a
    lane, follows), the (segment, transform) pairs a warp sweeps and the
    kernels.scan function giving its resident blocks an SM."""
    name: str
    entry: str
    pairs_a_warp: int
    blocks: str


# The least integer operations one cell of K8 (the SIM forward scan,
# csrc/sim_forward.cu) needs on sm_90, counted at the INT32 rate.  A cell
# keeps three (score, t) pairs, each one int64 key (score << 32) | t of two
# 32-bit words: a max of two keys is 4 operations (a compare of the low
# words, one of the high words with its carry, a select a word), a gap
# step subtracts a multiple of 2^32 and is 1 (the high word only).  The
# score 1 (a per-row table byte by the column's code); F 6 (two gap steps,
# one max); diag + s 1 and the restart 4 (the compare of the high word, t
# one add, a select a word); max with F 4; C = max(pre, D) 4; the next D 6
# (two gap steps, one max).  The stores of cs and ct are the bytes term.
SIM_OPS_PER_CELL = 1 + 6 + 5 + 4 + 4 + 6

K1_SCAN = ScanKernel("K1", "scan_colmax_kernel", 1, "blocks_per_sm")
K7_SCAN = ScanKernel("K7", "scan16_kernel", 2, "scan16_blocks_per_sm")

# The synthetic genome of phase 6: 34 Mb of random ACGT, past the CLI's
# 32 MiB `--tpu-stream auto` threshold (about 34.4 MB on disk).
GENOME_MB = 34
GENOME_SEED = 0
# and the smaller one whose streamed and batched outputs phase 6 compares
# (two records: 5 Mb and 0.5 Mb)
SMALL_GENOME_MB = 5.5


def synth_genome(path: str, mb: float, rna, seed: int = 0) -> int:
    """A synthetic chromosome-scale FASTA (copy of the generator of
    scripts/bench_genome.py): random ACGT in records of 5 Mb, about one
    homology of the query a 50 kb planted so that hits and clusters
    exist; returns the bases written."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    total = int(mb * 1e6)
    rec_len = 5_000_000
    written = 0
    with open(path, "w") as f:
        ri = 0
        while written < total:
            n = min(rec_len, total - written)
            seq = bases[rng.integers(0, 4, n)]
            # plant ~1 homology per 50 kb so hits and clusters exist
            for _ in range(max(1, n // 50_000)):
                lo = int(rng.integers(0, max(1, n - 400)))
                ql = int(rng.integers(60, min(300, len(rna))))
                qs = int(rng.integers(0, len(rna) - ql))
                piece = rna[qs:qs + ql].copy()
                muts = rng.random(ql) < 0.1
                piece[muts] = bases[rng.integers(0, 4, int(muts.sum()))]
                seq[lo:lo + ql] = piece
            f.write(f">synt|chr{ri + 1}|{written + 1}-{written + n}\n")
            s = seq.tobytes().decode("latin-1")
            for i in range(0, n, 80):
                f.write(s[i:i + 80] + "\n")
            written += n
            ri += 1
    return written


# the long-query run (phase 9): NEAT1 four times, each copy with 5% of its
# bases replaced, 91,068 nt, about KCNQ1OT1's length
LONG_COPIES = 4
LONG_MUTATED = 0.05
LONG_SEED = 0
# the 91 kb dispatches' rows repeated this many times fill the card
LONG_TILE = 16
# window rows of a dispatch held against the plain version in phase 9 (a
# seeded subset of each width class, beside every row whose offset or
# mreal passes 65,536)
LONG_HELD = 2048


def long_query(seed: int = LONG_SEED):
    """uint8 bases of the long query: oracle/NEAT1.fa's lncRNA LONG_COPIES
    times, each copy with LONG_MUTATED of its bases replaced by bases drawn
    from a generator seeded with seed (a replaced base may come out the
    same)."""
    import numpy as np

    with open(os.path.join(ORACLE, "NEAT1.fa")) as f:
        neat1 = np.frombuffer("".join(f.read().split("\n")[1:]).encode(),
                              np.uint8)
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    copies = []
    for _ in range(LONG_COPIES):
        c = neat1.copy()
        muts = rng.random(len(c)) < LONG_MUTATED
        c[muts] = bases[rng.integers(0, 4, int(muts.sum()))]
        copies.append(c)
    return np.concatenate(copies)


def vm_rss_mb(pid: int) -> float:
    """A process's resident set now (VmRSS of /proc/<pid>/status), MB;
    0 once it has exited."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024
    except OSError:
        pass
    return 0.0


def ptxas_registers() -> dict:
    """Registers per kernel entry (mangled name) from the ptxas report of
    the last build (build/kernels/build.log)."""
    import re

    from fasim_tpu_torch.kernels import _build

    regs, entry = {}, None
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found and entry:
            regs[entry] = int(found.group(1))
            entry = None
    return regs


# opcodes of a step loop that are no per-thread integer operation: shared,
# global, local and constant memory, shuffles, branches and barriers,
# special registers, and the uniform datapath (U...) and register moves
# (IMAD.MOV), which other pipes carry
NON_INTEGER = ("SHFL", "LDS", "LDG", "LDL", "LDC", "STG", "STS", "STL",
               "BRA", "BSSY", "BSYNC", "WARPSYNC", "NOP", "EXIT", "BAR",
               "S2R", "S2UR")


# the DPX cells' own opcodes (csrc/sw_colmax.cuh:CellI32DpxT::step,
# CellS16x2T::step), with any modifier (.RELU, the 16-bit forms' lane
# types)
CELL_OPS = ("PRMT", "VIADDMNMX", "VIMNMX", "VIMNMX3", "VIADD", "IMAD.MOV")


def _integer_op(op: str) -> bool:
    return not (op.split(".")[0] in NON_INTEGER or op.startswith("U")
                or op.startswith("IMAD.MOV"))


def _cell_op(op: str) -> bool:
    return any(op == c or op.startswith(c + ".") for c in CELL_OPS)


def _cell_relu(op: str) -> bool:
    """The add-max-relu of diag + s and E, one a row's cell (or, in K7,
    a row's two cells)."""
    return op.split(".")[0] == "VIADDMNMX" and "RELU" in op.split(".")


@functools.lru_cache(maxsize=1)
def library_sass() -> str:
    """`cuobjdump -sass` of the built library (build/kernels/
    libfasim_cuda.so), read once: it takes seconds, and the library does
    not change after phase 2."""
    from fasim_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass",
                           str(_build.BUILD_DIR / _build.LIB_NAME)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def sass_loop(kernel: str, text: str | None = None) -> dict:
    """SASS counts of a scan kernel's step loop, from the first kernel whose
    mangled name contains `kernel`, in `text` or else `library_sass()`.
    The step loop is the innermost loop (a predicated backward BRA: not
    one of the
    unconditional jumps back from the out-of-line divergence paths) around
    the kernel's first SHFL.UP;
    in it, the column block is what a lane runs for a column in range: the
    instructions between the innermost forward BRA around every
    VIADDMNMX.RELU of the loop (one a row, _cell_relu) and its target.
    Returns the loop's instruction count and integer operations
    (_integer_op), the block's instruction count, rows of cells ("cells"),
    integer operations, register moves and the cells' own instructions
    (CELL_OPS; the rest fetch the column), and the block's count by
    opcode."""
    import collections
    import re

    if text is None:
        text = library_sass()
    funcs = re.split(r"\n\s*Function : ", text)
    [body] = [f for f in funcs if f.split("\n", 1)[0].find(kernel) >= 0][:1]
    ins = []
    for line in body.splitlines():
        found = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if found:
            words = found.group(2).split()
            op = words[1] if words[0].startswith("@") else words[0]
            target = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)",
                               found.group(2))
            ins.append((int(found.group(1), 16), op,
                        int(target.group(1), 16) if target else None,
                        words[0].startswith("@")))
    shfl = next(a for a, op, _, _ in ins if op == "SHFL.UP")
    _, lo, hi = min((a - t, t, a) for a, _, t, pred in ins
                    if pred and t is not None and t <= shfl < a)
    ins = [(a, op, t) for a, op, t, _ in ins]
    loop = [(a, op, t) for a, op, t in ins if lo <= a <= hi]
    relu = [a for a, op, _ in loop if _cell_relu(op)]
    _, b_lo, b_hi = min((t - a, a, t) for a, _, t in loop
                        if t is not None and a < relu[0] and t > relu[-1])
    block = collections.Counter(op for a, op, _ in loop if b_lo < a < b_hi
                                and op != "BSYNC")
    return {"loop": len(loop),
            "loop_integer": sum(_integer_op(op) for _, op, _ in loop),
            "block": sum(block.values()),
            "cells": sum(n for op, n in block.items() if _cell_relu(op)),
            "integer": sum(n for op, n in block.items() if _integer_op(op)),
            "moves": sum(n for op, n in block.items()
                         if op.startswith("IMAD.MOV")),
            "cell_ops": sum(n for op, n in block.items() if _cell_op(op)),
            "opcodes": dict(block.most_common())}


def short_name(entry: str) -> str:
    """A kernel entry's mangled name without its namespace and parameter
    list: scan_colmax_kernelILi13E."""
    import re

    found = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernelI.*?E)E", entry or "")
    return found.group(1) if found else str(entry)


class SmokeError(AssertionError):
    """A phase's check failed."""


@contextlib.contextmanager
def switches(**env):
    """Set environment switches (FASIM_SCAN16, ...) for a block and put the
    previous values back after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def kept_environment():
    """Put the whole environment back as it was after the block."""
    saved = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def stdout_lines(text: str) -> list:
    """A run's stdout lines but the `Running time is` one."""
    return [ln for ln in text.splitlines()
            if not ln.startswith("Running time is")]


class Smoke:
    """State shared by the phases: inputs, diffs and times per kernel."""

    KERNELS = {
        "scan_colmax": ("fasim_tpu_torch/csrc/scan.cu",
                        "fasim_tpu/kernels/tpu.py:974"),
        "scan_colmax16": ("fasim_tpu_torch/csrc/scan16.cu",
                          "fasim_tpu/kernels/tpu.py:911"),
        "window_v1": ("fasim_tpu_torch/csrc/window_v1.cu",
                      "fasim_tpu/kernels/tpu.py:1364"),
        "window_v1_long": ("fasim_tpu_torch/csrc/window_pairs.cuh",
                           "fasim_tpu/kernels/tpu.py:1364"),
        "window_fwd": ("fasim_tpu_torch/csrc/window_fwd.cu",
                       "fasim_tpu/kernels/tpu.py:1796"),
        "window_general": ("fasim_tpu_torch/csrc/window_gen.cu",
                           "fasim_tpu/kernels/tpu.py:1529"),
        "window_general_long": ("fasim_tpu_torch/csrc/window_pairs.cuh",
                                "fasim_tpu/kernels/tpu.py:1529"),
        "scan_codes_colmax": ("fasim_tpu_torch/csrc/scan_codes.cu",
                              "fasim_tpu/kernels/tpu.py:154"),
        "sim_forward": ("fasim_tpu_torch/csrc/sim_forward.cu",
                        "fasim_tpu/kernels/sim_dev.py:71"),
    }

    def __init__(self):
        import numpy as np
        import torch

        self.np = np
        self.torch = torch
        self.dev = torch.device("cuda:0")
        self.rng = np.random.default_rng(SEED)
        self.err = {k: None for k in self.KERNELS}
        self.ms = {}
        self.plain_ms = {}
        self.launches = {}
        self.walls = {}
        self.counts = {}  # golden run -> its launch counts
        self.work = {}  # kernel -> (integer ops, bytes) of its timed call

    # -- helpers ---------------------------------------------------------

    def dna(self, n: int, alphabet: bytes = b"ACGT"):
        np = self.np
        return np.frombuffer(alphabet, np.uint8)[
            self.rng.integers(0, len(alphabet), n)].copy()

    def batch(self, seqs, n_pad: int):
        np = self.np
        segs = np.zeros((len(seqs), n_pad), np.uint8)
        lens = np.zeros(len(seqs), np.int32)
        for i, s in enumerate(seqs):
            segs[i, :len(s)] = s
            lens[i] = len(s)
        return segs, lens

    def engine(self, rna):
        from fasim_tpu_torch import rules
        from fasim_tpu_torch.kernels.engine import TorchScanEngine

        eng = TorchScanEngine(rna, device=self.dev)
        eng.setup_scans(rules.scan_list(0, 0))
        eng.setup_windows(rna)
        return eng

    def compare(self, kernel: str, got, want, what: str) -> None:
        """Exact equality of integer tensors; records the max |diff|."""
        torch = self.torch
        torch.cuda.synchronize()
        require(got.shape == want.shape,
                f"{kernel} {what}: shape {tuple(got.shape)} vs "
                f"{tuple(want.shape)}")
        diff = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        prev = self.err[kernel]
        self.err[kernel] = diff if prev is None else max(prev, diff)
        require(diff == 0, f"{kernel} {what}: max |kernel - plain| = {diff}")

    def cuda_ms(self, fn, reps: int, warm: bool = True) -> float:
        """Mean milliseconds of fn() over reps runs (after one warm-up)."""
        torch = self.torch
        if warm:
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    # -- phase 1 ---------------------------------------------------------

    def phase_device(self) -> None:
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        self.smi = smi.stdout.strip().splitlines()[0]
        print(self.smi)
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        require(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr}")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        mhz = float(clk.stdout.strip().splitlines()[0])
        self.sm_hz = mhz * 1e6
        self.int32_ops = sms * INT32_LANES * self.sm_hz
        print(f"int32 rate: {sms} SMs x {INT32_LANES} lanes x {mhz:.0f} MHz "
              f"(max SM clock) = {self.int32_ops:.4g} ops/s; memory "
              f"{MEM_BPS:.4g} B/s")
        print(f"device: {torch.cuda.get_device_name(0)}, "
              f"count {torch.cuda.device_count()}, torch {torch.__version__},"
              f" CUDA {torch.version.cuda}")

    # -- phase 2 ---------------------------------------------------------

    def phase_build(self) -> None:
        from fasim_tpu_torch.kernels import _build

        t0 = time.perf_counter()
        path = _build.build()
        _build.lib()
        print(f"built {os.path.relpath(path, REPO)} in "
              f"{time.perf_counter() - t0:.1f} s")
        # every kernel's registers are printed in phase 7; here the spills
        log = (_build.BUILD_DIR / "build.log").read_text()
        regs = ptxas_registers()
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line and not line.strip().startswith("0 bytes"):
                print(f"  ptxas: {short_name(entry)}: {line.strip()}")
        print(f"  ptxas: {len(regs)} kernel entries, {min(regs.values())}-"
              f"{max(regs.values())} registers")

    # -- phase 3 ---------------------------------------------------------

    def k1_case(self, name: str, rna, seqs, n_pad: int,
                k7_plain: bool = True):
        """K1 and K7 on both alphabets: kernel vs plain on the same device
        inputs (K7 against K1's plain version when not k7_plain).
        Returns K1's ssw pass (thresh, cm) and the batch."""
        from fasim_tpu_torch.kernels.scan import (
            decode_bases, in_gate16, scan_colmax, scan_colmax16,
            scan_colmax16_ref, scan_colmax_ref)

        torch = self.torch
        eng = self.engine(rna)
        segs, lens = self.batch(seqs, n_pad)
        bases, bases_rev = decode_bases(
            torch.from_numpy(segs).to(self.dev),
            torch.from_numpy(lens).to(self.dev))
        d = eng._dev
        require(in_gate16(48, eng.m16, n_pad), f"{name}: outside K7's gate")
        out = None
        for alpha, thresh in (("ssw", False), ("thresh", True)):
            args = (bases, bases_rev, d[f"lut6_{alpha[0]}"], d["istr"],
                    d[f"qp2_{alpha}"], eng.m16, thresh)
            cm_k, gm_k = scan_colmax(*args[:5], d[f"stab_{alpha}"],
                                     *args[5:])
            cm_p, gm_p = scan_colmax_ref(*args)
            self.compare("scan_colmax", cm_k, cm_p, f"{name}/{alpha} colmax")
            self.compare("scan_colmax", gm_k, gm_p, f"{name}/{alpha} max")
            cm_7, gm_7 = scan_colmax16(*args[:5], d[f"stab16_{alpha}"],
                                       *args[5:])
            if k7_plain:
                cm_p, gm_p = scan_colmax16_ref(*args)
            self.compare("scan_colmax16", cm_7, cm_p,
                         f"{name}/{alpha} colmax")
            self.compare("scan_colmax16", gm_7, gm_p, f"{name}/{alpha} max")
            if not thresh:
                out = (gm_k, cm_k)
                self.k7_max = int(gm_7.max())
        print(f"  K1, K7 {name}: S={len(seqs)} N={segs.shape[1]} "
              f"m={len(rna)} m16={eng.m16} T=48 max={int(out[0].max())} "
              "equal"
              + ("" if k7_plain else " (K7 against K1's plain version)"))
        return out, segs, lens, eng

    def k7_routing(self) -> None:
        """Under FASIM_SCAN16=1 the engine launches K7 inside the gate and
        K1 for an odd T, out of the gate (5 * min(m16, N) > 30000) and
        for the fused full-prefix rerun."""
        from fasim_tpu_torch import rules
        from fasim_tpu_torch.kernels.engine import TorchScanEngine

        rna = self.dna(MEG3_M)
        main = self.batch([self.dna(5000) for _ in range(8)], 5120)
        neat1 = self.dna(NEAT1_M)
        cases = (("inside the gate", rna, 48, main, False, "scan_colmax16"),
                 ("T=47", rna, 47, main, False, "scan_colmax"),
                 ("NEAT1 x N=6144", neat1, 48,
                  self.batch([self.dna(6000)], 6144), False, "scan_colmax"),
                 ("full-prefix rerun", rna, 48, main, True, "scan_colmax"))
        with switches(FASIM_SCAN16="1"):
            for name, q, n_scans, (segs, lens), full, want in cases:
                eng = TorchScanEngine(q, device=self.dev)
                eng.setup_scans(rules.scan_list(0, 0)[:n_scans])
                self.reset_counts()
                eng.scan_segments(segs, lens, full_prefix=full)
                self.torch.cuda.synchronize()
                counts = self.read_counts()
                got = {k: counts[k] for k in ("scan_colmax",
                                              "scan_colmax16")}
                require(got[want] == 1 and sum(got.values()) == 1,
                        f"K7 routing, {name}: launches {got}, want {want}")
                print(f"  FASIM_SCAN16=1, {name}: {want} only")

    def phase_kernels(self) -> None:
        np = self.np
        torch = self.torch
        from fasim_tpu_torch.kernels.pack import (pack_candidates,
                                                  pack_candidates_np)

        # K1 -----------------------------------------------------------
        rna = self.dna(MEG3_M)
        main = [self.dna(5000) for _ in range(64)]
        (gm, cm), segs, lens, eng = self.k1_case("main-path batch", rna,
                                                 main, 5120)
        self.main_k1 = (rna, segs, lens)
        # K7's own plain version (one launch chain a column) on the main
        # batch, the NEAT1-length query and the gate edge; the other cases
        # hold K7 against K1's plain version, the same function inside
        # K7's gate
        ragged = [self.dna(int(n)) for n in
                  self.rng.integers(100, 5001, 12)]
        self.k1_case("ragged", rna, ragged, 5120, k7_plain=False)
        ga = np.frombuffer(b"GA" * (MEG3_M // 2), np.uint8).copy()
        sat = [np.concatenate([self.dna(300), ga[:600], self.dna(400)])
               for _ in range(4)]
        (gm_s, _), *_ = self.k1_case("GA-rich saturating", ga, sat, 1408,
                                     k7_plain=False)
        require(int(gm_s.max()) >= 251, "GA batch did not saturate")
        rna_u = rna.copy()
        rna_u[self.rng.integers(0, len(rna_u), 20)] = ord("U")
        impure = [self.dna(1800, b"ACGTNacgt") for _ in range(4)]
        _, _, _, eng_u = self.k1_case("impure + U query", rna_u, impure,
                                      1920, k7_plain=False)
        require(not eng_u.query_pure, "U query must disable fused mode")
        # K1's strip edges: one full strip (m16 = 512), two strips with 48
        # zero rows above row 0 (528), three strips (1,040), with N and
        # lowercase bases
        for m in (512, 527, 1033):
            self.k1_case(f"strip edge m={m}", self.dna(m),
                         [self.dna(int(n), b"ACGTNacgt")
                          for n in self.rng.integers(1000, 2001, 6)], 2048,
                         k7_plain=False)
        # 5 * min(22768, 5120) = 25,600: inside K7's gate, 45 strips
        self.k1_case("NEAT1-length query", self.dna(NEAT1_M),
                     [self.dna(5000) for _ in range(2)], 5120)
        # the gate's edge, 5 * min(m16, N) = 30,000: GA repeats against GA
        # repeats score 5 a column on the transforms that read GA as GA
        # (rules.scan_list(0, 0)[25] and [31]), so H comes near 30,000
        ga6 = np.frombuffer(b"GA" * 3000, np.uint8).copy()
        self.k1_case("gate edge, GA repeats m = N = 6,000", ga6,
                     [ga6, ga6[1:]], 6000)
        require(self.k7_max >= 25000, f"gate edge: K7's largest per-pair "
                f"max {self.k7_max} < 25,000")
        print(f"  gate edge: K7's largest per-pair max {self.k7_max}")
        # -c 50000: the segment codes outgrow 48 KB of shared memory
        self.k1_case("wide segment", self.dna(100), [self.dna(50000)],
                     50048, k7_plain=False)
        self.k7_routing()

        # pack ---------------------------------------------------------
        lens_d = torch.from_numpy(lens).to(self.dev)
        pk = pack_candidates(gm, cm, lens_d, eng.PACK_K)
        want = pack_candidates_np(gm.cpu().numpy(), cm.cpu().numpy(), lens,
                                  eng.PACK_K)
        for got, ref, name in zip(pk, want, ("pos", "val", "cnt")):
            require(np.array_equal(got.cpu().numpy(), ref),
                    f"pack_candidates {name} differs from the numpy mirror")
        print(f"  pack_candidates: equal to the numpy mirror "
              f"(max cnt {int(want[2].max())})")
        self.window_checks(segs, lens, eng)
        self.capture = self.capture_specs()
        self.spec_checks()
        self.k5_checks()
        self.k8_checks()

    def window_checks(self, segs, lens, eng) -> None:
        """K3 and K6 on every width class, incl. rlens in (196, 256], of
        windows gathered from a batch; K3 on a NEAT1-length query; K4 and K6
        on random reverse windows at MEG3 and NEAT1 length; the gates of
        K3, K4 and K6."""
        np = self.np
        torch = self.torch
        from fasim_tpu_torch.kernels.window import (
            both_strands, gather_window_codes, width_class, window_fwd,
            window_pass_ref)

        segs_d = torch.from_numpy(segs).to(self.dev)
        both = both_strands(segs_d, torch.from_numpy(lens).to(self.dev))
        S, N = segs.shape
        d = eng._dev
        rows = 512
        for lo, hi in ((1, 32), (25, 48), (49, 64), (65, 96), (97, 128),
                       (129, 196), (197, 256)):
            rl = self.rng.integers(lo, hi + 1, rows).astype(np.int32)
            seg_idx = self.rng.integers(0, S, rows).astype(np.int32)
            base = np.array([self.rng.integers(0, max(1, lens[s] - r + 1))
                             for s, r in zip(seg_idx, rl)], np.int32)
            spec = [torch.from_numpy(a).to(self.dev) for a in (
                seg_idx, self.rng.integers(0, 48, rows).astype(np.int32),
                base, np.ones(rows, np.int32), rl)]
            W = int(width_class(rl).max())
            codes = gather_window_codes(both, S, N, d["lut_s"], d["is_tr"],
                                        *spec, W)
            qp = d["qwin_fwd"]
            got = window_fwd(codes, qp, d["wtab_fwd"], spec[4], eng.m,
                             eng.m16)
            full = lambda v: torch.full((rows,), v, dtype=torch.int32,
                                        device=self.dev)
            want = window_pass_ref(codes, qp, full(0), full(-1), spec[4],
                                   full(eng.m16), eng.m)
            self.compare("window_fwd", got, want, f"rlens {lo}..{hi}")
            print(f"  K3 rlens {lo}..{hi} (W={W}): {rows} rows equal, "
                  f"best max {int(want[:, 0].max())}")
            self.k6_compare(codes, full(0), full(-1), spec[4], full(eng.m16),
                            eng, False, f"rlens {lo}..{hi}")
            print(f"  K6 (both forms) rlens {lo}..{hi} (W={W}): {rows} "
                  "rows equal")
        self.k3_neat1()
        for m in (MEG3_M, NEAT1_M, LONG_COPIES * NEAT1_M):
            self.k4_checks(m)
        self.gates()
        self.k6_gate()

    def spec_checks(self) -> None:
        """K4, K3 and K6 on the specs of a real candidate stage."""
        from fasim_tpu_torch.kernels.window import (window_fwd,
                                                    window_general,
                                                    window_general_long,
                                                    window_pass_ref)

        for rev in (False, True):
            calls = [c for c in self.capture if c[3] == rev]
            n = 0
            for segs_c, lens_c, spec, _ in calls:
                for W, codes, part in self.spec_codes(self.cap_eng, segs_c,
                                                      lens_c, spec, rev):
                    qp = self.cap_eng._dev["qwin_rev" if rev else "qwin_fwd"]
                    args = (codes, qp, part["offs"], part["terms"],
                            part["rlens"], part["mreals"], self.cap_eng.m)
                    want = window_pass_ref(*args)
                    what = f"{'rev' if rev else 'fwd'} specs W={W}"
                    tab = self.cap_eng._dev["wtab_rev" if rev
                                            else "wtab_fwd"]
                    self.compare("window_general",
                                 window_general(*args, tab), want, what)
                    self.compare("window_general_long",
                                 window_general_long(*args, tab), want, what)
                    if not rev:  # the production forward specs are K3's
                        self.compare("window_fwd", window_fwd(
                            codes, qp, self.cap_eng._dev["wtab_fwd"],
                            part["rlens"], self.cap_eng.m,
                            self.cap_eng.m16), want, f"fwd specs W={W}")
                    n += codes.shape[0]
                    self.k6_compare(codes, part["offs"], part["terms"],
                                    part["rlens"], part["mreals"],
                                    self.cap_eng, rev, f"specs W={W}")
            print(f"  {'K4' if rev else 'K3, K4'} (both K4 forms), K6 "
                  f"(both forms) {'reverse' if rev else 'forward'} specs "
                  f"of a real candidate stage: {n} rows equal")

    # -- K3 --------------------------------------------------------------

    def k3_neat1(self) -> None:
        """K3 against its plain version on a NEAT1-length query, every width
        class: the score table far past MEG3's rows, row indices past
        2**14."""
        np = self.np
        torch = self.torch
        from fasim_tpu_torch.kernels.window import (window_fwd,
                                                    window_pass_ref)

        eng = self.engine(self.dna(NEAT1_M))
        rows = 255  # odd: the last pair has one window
        for lo, hi, W in ((1, 64, 64), (65, 128, 128), (129, 256, 256)):
            rl = self.rng.integers(lo, hi + 1, rows).astype(np.int32)
            codes = self.rng.integers(0, 5, (rows, W)).astype(np.uint8)
            codes[np.arange(W)[None, :] >= rl[:, None]] = 4
            codes_d = torch.from_numpy(codes).to(self.dev)
            rl_d = torch.from_numpy(rl).to(self.dev)
            full = lambda v: torch.full((rows,), v, dtype=torch.int32,
                                        device=self.dev)
            qp = eng._dev["qwin_fwd"]
            want = window_pass_ref(codes_d, qp, full(0), full(-1), rl_d,
                                   full(eng.m16), eng.m)
            self.compare("window_fwd", window_fwd(
                codes_d, qp, eng._dev["wtab_fwd"], rl_d, eng.m, eng.m16),
                want, f"NEAT1-length rlens {lo}..{hi}")
            print(f"  K3 NEAT1-length query (m={eng.m}), rlens {lo}..{hi} "
                  f"(W={W}): {rows} rows equal, max end_row "
                  f"{int(want[want[:, 0] > 0, 2].max())}")

    # -- K4 --------------------------------------------------------------

    def k4_checks(self, m: int) -> None:
        """K4's two forms (16-bit row keys while m <= K3_MAX_M, and the
        long form) against the plain version, and K6's two forms against
        their plain chain, on every width class, at query length m, on
        reverse-query rows with random offs (half the windows copy the
        query from their offset on, mutated), terms (none, or near the
        window's best: real cuts) and mreals: once with few distinct
        offsets (pairs share their start row) and mreals m..m+15, once with
        distinct offsets (every pair mismatches) and mreals m-8..m+15.  K6
        takes each width's cases in one call (its plain chain steps every
        query row, whatever the rows); past K3_MAX_M, where that chain
        would step every one of m rows, K6's long form is held against K4's
        plain version (v1's ends and K4's cannot differ)."""
        np = self.np
        torch = self.torch
        from fasim_tpu_torch.kernels.window import (K3_MAX_M, window_general,
                                                    window_general_long,
                                                    window_pass_ref)
        from fasim_tpu_torch.kernels.window_v1 import window_v1_long

        eng = self.engine(self.dna(m))
        d = eng._dev
        q = d["qwin_rev"][0].cpu().numpy()
        rows = 301  # odd: the last pair has one window

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                self.dev)

        k6 = {}  # W -> the cases' (codes, offs, terms, rlens, mreals)
        for lo, hi, W in ((1, 32, 64), (33, 64, 64), (1, 64, 64),
                          (65, 128, 128), (129, 256, 256)):
            for pairs in ("shared", "mismatched"):
                rl = self.rng.integers(lo, hi + 1, rows)
                if pairs == "shared":
                    offs = self.rng.choice(self.rng.integers(0, m, 6), rows)
                else:
                    offs = self.rng.choice(m, rows, replace=False)
                codes = self.rng.integers(0, 5, (rows, W)).astype(np.uint8)
                for r in range(0, rows, 2):
                    n = min(m - offs[r], rl[r])
                    piece = q[offs[r]:offs[r] + n].copy()
                    muts = self.rng.random(n) < 0.15
                    piece[muts] = self.rng.integers(0, 5, int(muts.sum()))
                    codes[r, :n] = piece
                codes[np.arange(W)[None, :] >= rl[:, None]] = 4
                codes_d = torch.from_numpy(codes).to(self.dev)
                # mreals below m too, where the offsets mismatch
                mreals = m + self.rng.integers(
                    -8 if pairs == "mismatched" else 0, 16, rows)
                free = window_pass_ref(codes_d, d["qwin_rev"], dev(offs),
                                       dev(np.full(rows, -1)), dev(rl),
                                       dev(mreals), m)[:, 0].cpu().numpy()
                terms = np.where(self.rng.random(rows) < 0.5, -1,
                                 np.maximum(free - self.rng.integers(
                                     0, 3, rows), 0))
                args = (codes_d, d["qwin_rev"], dev(offs), dev(terms),
                        dev(rl), dev(mreals), m)
                want = window_pass_ref(*args)
                what = f"m={m} rlens {lo}..{hi} {pairs} offsets"
                if m <= K3_MAX_M:
                    self.compare("window_general",
                                 window_general(*args, d["wtab_rev"]), want,
                                 what)
                self.compare("window_general_long",
                             window_general_long(*args, d["wtab_rev"]), want,
                             what)
                if m > K3_MAX_M:
                    self.compare("window_v1_long", window_v1_long(
                        codes_d, eng._qcodes(True), *args[2:],
                        d["wtab_rev"]), want, what)
                k6.setdefault(W, []).append(
                    (codes_d, *map(dev, (offs, terms, rl, mreals))))
                print(f"  K4 ({'long form' if m > K3_MAX_M else 'both forms'}"
                      f"{', K6 long form' if m > K3_MAX_M else ''}) {what} "
                      f"(W={W}): {rows} rows equal, best max "
                      f"{int(want[:, 0].max())}, max end_row "
                      f"{int(want[want[:, 0] > 0, 2].max())}")
        for W, cases in k6.items():
            if m > K3_MAX_M or (m > MEG3_M and W > 64):
                # K6's plain chain steps every query row: at NEAT1 length
                # the 64-column cases only (the wider ones at MEG3's)
                continue
            cols = [torch.cat(c) for c in zip(*cases)]
            self.k6_compare(*cols, eng, True, f"m={m} W={W}")
            print(f"  K6 (both forms) m={m}, the {len(cases)} cases of "
                  f"W={W} above: {int(cols[0].shape[0])} rows equal")

    def gates(self) -> None:
        """The engine's 16-bit row gates: at m = K3_MAX_M uniform forward
        specs go to K3 and reverse specs to K4's 16-bit row keys, one query
        row longer both to K4's long form; all equal to the plain version.
        The launches of the longer query are printed here, not in the
        report's main-path counts."""
        np = self.np
        torch = self.torch
        from fasim_tpu_torch.kernels.window import (K3_MAX_M, both_strands,
                                                    gather_window_codes,
                                                    window_pass_ref)

        segs, lens = self.batch([self.dna(3000) for _ in range(4)], 3072)
        segs_d = torch.from_numpy(segs).to(self.dev)
        lens_d = torch.from_numpy(lens).to(self.dev)
        rows = 200
        rl = self.rng.integers(10, 65, rows).astype(np.int32)
        seg_idx = self.rng.integers(0, len(lens), rows).astype(np.int32)
        base = np.array([self.rng.integers(0, lens[i] - r + 1)
                         for i, r in zip(seg_idx, rl)], np.int32)
        scan_idx = self.rng.integers(0, 48, rows).astype(np.int32)
        long_launches = 0
        for m in (K3_MAX_M, K3_MAX_M + 1):
            eng = self.engine(self.dna(m))
            d = eng._dev
            m16 = eng.m16
            kinds = (
                ("uniform forward", False, np.zeros(rows, np.int32),
                 np.full(rows, -1, np.int32), np.full(rows, m16, np.int32),
                 "window_fwd" if m <= K3_MAX_M else "window_general_long"),
                ("reverse", True,
                 self.rng.integers(0, m, rows).astype(np.int32),
                 self.rng.integers(-1, 40, rows).astype(np.int32),
                 (m + self.rng.integers(0, 16, rows)).astype(np.int32),
                 "window_general" if m <= K3_MAX_M
                 else "window_general_long"))
            for what, rev, offs, terms, mreals, want_k in kinds:
                spec = {"seg_idx": seg_idx, "scan_idx": scan_idx,
                        "base": base, "dirn": np.ones(rows, np.int32),
                        "rlens": rl, "offs": offs, "terms": terms,
                        "mreals": mreals}
                self.reset_counts()
                got = eng.window_pass_specs(segs, lens, spec, rev=rev)
                torch.cuda.synchronize()
                counts = self.read_counts()
                require(counts[want_k] == 1 and sum(counts.values()) == 1,
                        f"gate, m={m}, {what}: launches {counts}, want "
                        f"{want_k}")
                long_launches += counts["window_general_long"]
                cols = [torch.from_numpy(a).to(self.dev) for a in (
                    seg_idx, scan_idx, base, spec["dirn"], rl, offs, terms,
                    mreals)]
                codes = gather_window_codes(both_strands(segs_d, lens_d),
                                            *segs.shape, d["lut_s"],
                                            d["is_tr"], *cols[:5], 64)
                want = window_pass_ref(
                    codes, d["qwin_rev" if rev else "qwin_fwd"], cols[5],
                    cols[6], cols[4], cols[7], eng.m)
                self.compare(want_k, torch.from_numpy(got).to(self.dev),
                             want, f"gate m={m} {what}")
                print(f"  gate, m={m}: {what} specs on {want_k} only, "
                      f"{rows} rows equal")
        # the kernels line gives window_general_long the launches of phase
        # 5's 91 kb run, its main path
        print(f"  window_general_long launches in the gate checks (not a "
              f"main path): {long_launches}")

    # -- K6 --------------------------------------------------------------

    def k6_compare(self, codes, offs, terms, rlens, mreals, eng,
                   rev: bool, what: str) -> None:
        """K6's two forms (window_v1 with 16-bit row keys, window_v1_long)
        against the plain chain v1_ends (window_keys_ref -> decode_key ->
        ends_from_stats) on one width class, on eng's query codes and
        score table."""
        from fasim_tpu_torch.kernels.window_v1 import (v1_ends, window_v1,
                                                       window_v1_long)

        qc = eng._qcodes(rev)
        args = (codes, qc, offs, terms, rlens, mreals, eng.m)
        want = v1_ends(*args)
        what = f"{'rev' if rev else 'fwd'} {what}"
        tab = eng._dev["wtab_rev" if rev else "wtab_fwd"]
        self.compare("window_v1", window_v1(*args, tab), want, what)
        self.compare("window_v1_long", window_v1_long(*args, tab), want,
                     what)

    def k6_gate(self) -> None:
        """K6's 16-bit row gate, by the query rows nq = query_rows(m): at m =
        K6_MAX_NQ - 15 (nq = K6_MAX_NQ) a dispatch whose largest mreal is
        nq launches K6's 16-bit row keys only; one query row longer (m =
        K6_MAX_NQ - 14, nq = 65,664), dispatches whose largest mreal is
        65,536 and 65,537 launch the long form only.  All equal K4's plain
        version window_pass_ref (v1's ends and K4's cannot differ; K6's own
        plain chain, held against both forms in k6_compare, would step all
        65,5xx query rows here).  The launches are printed here, not in the
        report's main-path counts."""
        np = self.np
        torch = self.torch
        from fasim_tpu_torch.kernels.window import window_pass_ref
        from fasim_tpu_torch.kernels.window_v1 import K6_MAX_NQ, window_v1

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

        long_launches = 0
        for m in (K6_MAX_NQ - 15, K6_MAX_NQ - 14):
            eng = self.engine(self.dna(m))
            qc = eng._qcodes(True)
            q = qc[:m].cpu().numpy()
            rows, W = 200, 64
            rl = self.rng.integers(10, W + 1, rows)
            offs = np.concatenate([self.rng.integers(0, m, rows - 4),
                                   [m - 40, m - 20, m - 5, m - 1]])
            codes = self.rng.integers(0, 5, (rows, W)).astype(np.uint8)
            for r in range(rows):  # copy the query from the offset, mutated
                n = min(m - offs[r], rl[r])
                piece = q[offs[r]:offs[r] + n].copy()
                muts = self.rng.random(n) < 0.15
                piece[muts] = self.rng.integers(0, 5, int(muts.sum()))
                codes[r, :n] = piece
            codes[np.arange(W)[None, :] >= rl[:, None]] = 4
            mreals = m + self.rng.integers(0, 14, rows)
            terms = np.where(self.rng.random(rows) < 0.5, -1,
                             self.rng.integers(0, 40, rows))
            if m < K6_MAX_NQ - 14:
                mreals[-1] = qc.numel()  # the last keyed row of the gate
                cases = ((f"largest mreal {qc.numel()}", rows, "window_v1"),)
            else:
                mreals[-3:] = K6_MAX_NQ  # 65,536
                mreals[-1] = K6_MAX_NQ + 1  # one past it
                cases = tuple((f"largest mreal {top}", n, "window_v1_long")
                              for top, n in ((K6_MAX_NQ, rows - 1),
                                             (K6_MAX_NQ + 1, rows)))
            cols = [dev(codes), *(dev(a.astype(np.int32)) for a in (
                offs, terms, rl, mreals))]
            want = window_pass_ref(cols[0], eng._dev["qwin_rev"], *cols[1:],
                                   m)
            for what, n, kernel in cases:
                c, o, t, r, mr = (a[:n].contiguous() for a in cols)
                self.reset_counts()
                got = window_v1(c, qc, o, t, r, mr, m, eng._dev["wtab_rev"])
                torch.cuda.synchronize()
                counts = self.read_counts()
                require(counts[kernel] > 0 and sum(counts.values())
                        == counts[kernel], f"K6 gate, m={m}, {what}: "
                        f"launches {counts}, want {kernel}")
                long_launches += counts["window_v1_long"]
                self.compare(kernel, got, want[:n], f"gate m={m} {what}")
                print(f"  K6 gate, m={m} ({qc.numel()} query rows): {what} "
                      f"on {kernel} only, {n} rows equal, max end_row "
                      f"{int(want[:n][want[:n, 0] > 0, 2].max())}")
        print(f"  window_v1_long launches in the K6 gate check (not a main "
              f"path): {long_launches}")

    # -- K5 --------------------------------------------------------------

    def k5_codes(self, which: str, rows, n_pad: int):
        """uint8[1, len(rows), n_pad] engine codes of byte rows, ragged
        rows padded with the alphabet's out-of-alphabet code."""
        np = self.np
        from fasim_tpu_torch import rules
        from fasim_tpu_torch.kernels.scan_codes import PAD_CODE

        enc = rules.SSW_ENC if which == "ssw" else rules.THRESH_ENC
        out = np.full((1, len(rows), n_pad), PAD_CODE[which], np.uint8)
        for i, r in enumerate(rows):
            out[0, i, :len(r)] = enc[r]
        return out

    def k5_case(self, name: str, rna, rows, n_pad: int,
                alphabets=("ssw", "thresh"), shape=None, plans=(None,),
                high: float = 0.0):
        """K5 kernel vs plain on the same device inputs, per alphabet and
        per launch plan (rows a lane, warps; None: the library's plan),
        with a share `high` of the codes replaced by codes >= 8; returns
        the last kernel output."""
        torch = self.torch
        from fasim_tpu_torch.kernels.engine import TorchScanEngine
        from fasim_tpu_torch.kernels.scan_codes import (
            kernel_plan, scan_codes_colmax, scan_codes_colmax_ref)

        eng = TorchScanEngine(rna, device=self.dev)
        got = None
        for which in alphabets:
            codes = self.k5_codes(which, rows, n_pad)
            hit = self.rng.random(codes.shape) < high
            codes[hit] = self.rng.integers(8, 256, int(hit.sum()))
            if shape is not None:
                codes = codes.reshape(shape)
            codes_d = torch.from_numpy(codes).to(self.dev)
            args = (codes_d, eng._dev[f"qprops_{which}"])
            want = scan_codes_colmax_ref(*args, eng.m16, which)
            for plan in plans:
                got = scan_codes_colmax(*args, eng._dev[f"ctab_{which}"],
                                        eng.m16, which, plan=plan)
                self.compare("scan_codes_colmax", got, want,
                             f"{name}/{which} plan {plan or 'library'}")
        own = kernel_plan(codes.size // n_pad, eng.m16)
        print(f"  K5 {name}: {tuple(codes.shape)} m={len(rna)} "
              f"{'+'.join(alphabets)}, plans (rows a lane, warps) "
              + ", ".join(f"{p}" if p else f"{own} (library)"
                          for p in plans)
              + f"{f', {high:.0%} codes >= 8' if high else ''}: "
              f"max={int(got.max())} equal")
        return got

    def k5_checks(self) -> None:
        """K5 at the launch plan's edges: one strip (a short query), strips
        = warps, strips > warps (the wrap through the scratch row), one
        warp over several strips (a packed batch's plan), on the
        per-segment shape, a packed batch, ragged impure rows with a U
        query, GA rows past 251 and a NEAT1-length query."""
        np = self.np
        T = 48
        rna = self.dna(MEG3_M)
        self.k5_rna = rna
        self.k5_seg = [self.dna(5000) for _ in range(T)]
        # m16 = 1,584: 4 strips of 13 rows a lane, 7 of 8, 13 of 4
        self.k5_case("per-segment shape", rna, self.k5_seg, 5000,
                     plans=(None, (13, 4), (13, 2), (8, 4), (13, 1),
                            (4, 13)), high=0.02)
        # m16 = 240: one strip of 8 rows a lane (the library's plan), or
        # of 8 with a warp idle, or 4 strips of 2 on 4 warps
        self.k5_case("short query", self.dna(230),
                     [self.dna(int(n)) for n in
                      self.rng.integers(600, 1001, T)], 1000,
                     plans=(None, (8, 2), (2, 4)), high=0.02)
        # few columns: less than one 32-column block, and a block and a
        # bit, through the rings and through the scratch row
        for n in (5, 40):
            self.k5_case(f"{n} columns", rna, [self.dna(n) for _ in range(T)],
                         n, plans=(None, (13, 2)), high=0.02)
        packed = [self.dna(5120) for _ in range(64 * T)]
        self.k5_case("packed batch", rna, packed, 5120, ("ssw",),
                     shape=(64, T, 5120), high=0.01)
        rna_u = rna.copy()
        rna_u[self.rng.integers(0, len(rna_u), 20)] = ord("U")
        impure = [self.dna(int(n), b"ACGTNUacgt")
                  for n in self.rng.integers(1200, 1801, T)]
        self.k5_case("impure + U query, ragged", rna_u, impure, 1800,
                     plans=(None, (7, 8)), high=0.02)
        ga = np.frombuffer(b"GA" * (MEG3_M // 2), np.uint8).copy()
        sat = [np.concatenate([self.dna(300), ga[:600], self.dna(400)])
               for _ in range(8)]
        got = self.k5_case("GA-rich past 251", ga, sat, 1300)
        require(int(got.max()) > 255, "K5 GA rows did not pass 255")
        # m16 = 22,768: 45 strips of 16 rows a lane, on 16 warps (three
        # rounds through the scratch row) and on 7
        self.k5_case("NEAT1-length query", self.dna(NEAT1_M),
                     [self.dna(900) for _ in range(T)], 900,
                     plans=(None, (16, 7)), high=0.02)
        self.k5_engine_call()

    def k5_engine_call(self) -> None:
        """The per-segment call engine(rna, seq2_list) on the card against
        the same call on a CPU engine, for one real MEG3 segment."""
        from fasim_tpu_torch import rules
        from fasim_tpu_torch.io import fasta
        from fasim_tpu_torch.kernels.engine import TorchScanEngine

        _, rna = fasta.read_rna(os.path.join(ORACLE, "MEG3.fa"))
        seg = fasta.read_dna(os.path.join(ORACLE, "meg3sub3.fa"))[0].seq
        seq2 = [rules.make_scan_strings(seg, s)[0]
                for s in rules.scan_list(0, 0)]
        t0 = time.perf_counter()
        got = TorchScanEngine(rna, device=self.dev)(rna, seq2)
        want = TorchScanEngine(rna, device="cpu")(rna, seq2)
        for g, w, what in zip(got, want, ("thresh", "colmax")):
            self.compare("scan_codes_colmax", self.torch.from_numpy(g),
                         self.torch.from_numpy(w), f"engine call {what}, "
                         "cuda vs cpu")
        print(f"  K5 engine(rna, seq2_list) on a {len(seg)} nt MEG3 segment:"
              f" cuda == cpu (max thresh {int(got[0].max())}, "
              f"{time.perf_counter() - t0:.1f} s)")

    def k8_case(self, name: str, rna, refs, rows=None, timed=False):
        """K8 sim_forward against its plain version on one query and T
        references, exact on cs and ct; returns the device inputs (q, refs,
        m) and, when `timed`, the plain version's milliseconds."""
        torch = self.torch
        from fasim_tpu_torch.kernels.sim_dev import (encode, kernel_rows,
                                                     sim_forward,
                                                     sim_forward_ref)

        q, r = encode(rna, refs)
        qd = torch.from_numpy(q).to(self.dev)
        rd = torch.from_numpy(r).to(self.dev)
        m = len(rna)
        got = sim_forward(qd, rd, m, rows=rows)
        box = []
        plain = self.cuda_ms(lambda: box.append(sim_forward_ref(qd, rd, m)),
                             1, warm=False)
        want = box[0]
        self.compare("sim_forward", got[0], want[0], f"{name}: cs")
        self.compare("sim_forward", got[1], want[1], f"{name}: ct")
        print(f"  K8 sim_forward {name} (T={r.shape[0]} m={m} N={r.shape[1]},"
              f" {rows or kernel_rows(m, r.shape[1], r.shape[0])} rows a "
              "lane): exact"
              + (f", plain {plain:.3f} ms" if timed else ""))
        return (qd, rd, m), plain

    def k8_checks(self) -> None:
        """K8 against its plain version: random pairs, planted homology,
        a run of N, a non-ACGT query, short queries, every instantiation
        at its strip edges, h19_F's full group and a NEAT1-length pair;
        sim_forward_cells on h19_F's group against the numpy mirror of the
        JAX package's host compaction."""
        np = self.np
        from fasim_tpu_torch import rules
        from fasim_tpu_torch.config import Params
        from fasim_tpu_torch.io import fasta
        from fasim_tpu_torch.kernels.sim_dev import (KERNEL_ROWS,
                                                     sim_forward_cells)

        def planted(rna, n):
            ref = self.dna(n)
            ql = min(len(rna), n) * 2 // 3
            lo = int(self.rng.integers(0, n - ql + 1))
            piece = rna[:ql].copy()
            muts = self.rng.random(ql) < 0.1
            piece[muts] = self.dna(int(muts.sum()))
            ref[lo:lo + ql] = piece
            return ref

        self.k8_case("random pairs", self.dna(500),
                     [self.dna(800) for _ in range(3)])
        rna = self.dna(400)
        self.k8_case("planted homology, 10% mutated", rna,
                     [planted(rna, 900) for _ in range(2)])
        nrun = planted(rna, 700)
        nrun[200:330] = ord("N")
        self.k8_case("a run of N", rna,
                     [nrun, planted(rna, 700)[::-1].copy()])
        rna_n = rna.copy()
        rna_n[[5, 77, 301]] = np.frombuffer(b"NuR", np.uint8)
        self.k8_case("non-ACGT query bytes", rna_n, [planted(rna, 600)])
        for m in (1, 7, 8, 31, 32, 33):
            self.k8_case(f"m={m}", self.dna(m),
                         [self.dna(300) for _ in range(2)])
        for rows in KERNEL_ROWS:
            for m in (32 * rows, 32 * rows + 1, 96 * rows - 1):
                rna = self.dna(m)
                self.k8_case(f"strip edge m={m}", rna,
                             [planted(rna, 200), self.dna(200)], rows=rows)
        self.k8_edges(planted)
        # h19_F's group: H19 x testDNA's one segment, the first two
        # transforms (the driver's groups of 2 at this shape)
        p = Params()
        _, h19 = fasta.read_rna(os.path.join(ORACLE, "H19.fa"))
        [rec] = fasta.read_dna(os.path.join(ORACLE, "testDNA.fa"))
        [seg], _ = fasta.cut_sequence(rec.seq, p.cut_length,
                                      p.overlap_length)
        scans = rules.scan_list(p.rule, p.strand)
        pairs = [rules.make_scan_strings(seg, sc) for sc in scans[:2]]
        refs = [ref for ref, _ in pairs]
        self.k8_h19, self.k8_plain_h19 = self.k8_case(
            "h19_F group", h19, refs, timed=True)
        _, neat1 = fasta.read_rna(os.path.join(ORACLE, "NEAT1.fa"))
        require(len(neat1) == NEAT1_M, f"NEAT1 has {len(neat1)} nt")
        self.k8_neat1, self.k8_plain_neat1 = self.k8_case(
            "NEAT1 length", neat1, [planted(neat1, 5000)], timed=True)
        # the qualifying cells of h19_F's group at the segment's real
        # thresholds (K1's, as the driver reads them)
        eng = self.engine(h19)
        segs, lens = self.batch([seg], (len(seg) + 127) // 128 * 128)
        gm = eng.scan_segments(segs, lens)[0].cpu().numpy()[0]
        mins = [int(int(gm[k]) * 0.8) for k in range(2)]
        got = sim_forward_cells(h19, refs, mins, self.dev)
        self.k8_group = (h19, refs, mins)
        self.k8_pair = (h19, *pairs[0], mins[0], scans[0], got[0])
        want = self.cells_mirror(*self.k8_h19, mins)
        for t, (g, w) in enumerate(zip(got, want)):
            require(g.dtype == np.int32 and np.array_equal(g, w),
                    f"sim_forward_cells pair {t} differs from the numpy "
                    "mirror")
        n_cells = self.k8_h19[1].shape[1] * len(h19)
        print(f"  sim_forward_cells, h19_F group (min scores {mins}): equal "
              f"to the numpy mirror, "
              + ", ".join(f"{len(g)} cells ({len(g) / n_cells:.1%})"
                          for g in got))

    K8_EDGE_N = (1, 31, 32, 33, 63, 64, 65)

    def k8_edges(self, planted) -> None:
        """K8 at the column edges of its cell ring and of its row-above
        batches (N in K8_EDGE_N), with m at strip edges (a row short of
        one strip, a row into the second, a row into the third), for every
        instantiation, T = 2, exact against its plain version on cs and
        ct."""
        torch = self.torch
        from fasim_tpu_torch.kernels.sim_dev import (KERNEL_ROWS, encode,
                                                     sim_forward,
                                                     sim_forward_ref)

        for rows in KERNEL_ROWS:
            band = 32 * rows
            ms = sorted({max(1, band - 1), band + 1, 2 * band + 1})
            for m in ms:
                for n in self.K8_EDGE_N:
                    rna = self.dna(m)
                    q, r = encode(rna, [planted(rna, n), self.dna(n)])
                    qd = torch.from_numpy(q).to(self.dev)
                    rd = torch.from_numpy(r).to(self.dev)
                    got = sim_forward(qd, rd, m, rows=rows)
                    want = sim_forward_ref(qd, rd, m)
                    what = f"rows={rows} m={m} N={n}"
                    self.compare("sim_forward", got[0], want[0],
                                 f"{what}: cs")
                    self.compare("sim_forward", got[1], want[1],
                                 f"{what}: ct")
            print(f"  K8 sim_forward at {rows} rows a lane: "
                  f"{len(ms) * len(self.K8_EDGE_N)} edge cases (N in "
                  f"{list(self.K8_EDGE_N)}, m in {ms}), exact")

    def cells_mirror(self, q, refs, m, mins):
        """The JAX package's host compaction (fasim_tpu/kernels/sim_dev.py:
        sim_forward_cells, after the scan) in numpy, on K8's (cs, ct)
        laid out as JAX's [T, N, m]."""
        np = self.np
        from fasim_tpu_torch.kernels.sim_dev import sim_forward

        cs, ct = sim_forward(q, refs, m)
        cs = cs.cpu().numpy().transpose(0, 2, 1)
        ct = ct.cpu().numpy().transpose(0, 2, 1)
        n = refs.shape[1]
        outs = []
        for t in range(cs.shape[0]):
            jj, ii = np.nonzero(cs[t] > int(mins[t]))
            c = cs[t][jj, ii]
            st = ct[t][jj, ii]
            ci = st // (n + 2)
            cj = st - ci * (n + 2)
            cells = np.column_stack([c, ci, cj, ii + 1, jj + 1]) \
                .astype(np.int32)
            order = np.lexsort((cells[:, 4], cells[:, 3]))
            outs.append(np.ascontiguousarray(cells[order]))
        return outs

    def spec_codes(self, eng, segs_c, lens_c, spec, rev):
        """Per width class of a dispatch of eng: (W, codes, spec columns) on
        the card; the columns' "sel" holds the class's rows of the dispatch
        (numpy)."""
        np = self.np
        torch = self.torch
        from fasim_tpu_torch.kernels.engine import SPEC_KEYS
        from fasim_tpu_torch.kernels.window import (WIDTHS, both_strands,
                                                    gather_window_codes,
                                                    width_class)

        d = eng._dev
        segs_d = torch.as_tensor(segs_c, device=self.dev)
        S, N = segs_d.shape
        both = both_strands(segs_d, torch.as_tensor(lens_c,
                                                    device=self.dev))
        klass = width_class(spec["rlens"])
        out = []
        for W in WIDTHS:
            sel = np.flatnonzero(klass == W)
            if not len(sel):
                continue
            part = {k: torch.from_numpy(np.ascontiguousarray(
                spec[k][sel], np.int32)).to(self.dev) for k in SPEC_KEYS}
            codes = gather_window_codes(
                both, S, N, d["lut_s"], d["is_tr"], part["seg_idx"],
                part["scan_idx"], part["base"], part["dirn"], part["rlens"],
                W)
            part["sel"] = sel
            out.append((W, codes, part))
        return out

    def capture_specs(self):
        """Run the port's batched scan on oracle/meg3sub64.fa (64 records, one
        full 64-segment batch) x MEG3 and keep every window dispatch."""
        from fasim_tpu_torch.config import Params
        from fasim_tpu_torch.io import fasta
        from fasim_tpu_torch.kernels.engine import TorchScanEngine
        from fasim_tpu_torch.scan.batched import scan_records

        calls = []
        np_copy = self.np.array

        class Recording(TorchScanEngine):
            def window_pass_specs(self, segs, lengths, spec, rev):
                calls.append((segs, np_copy(lengths),
                              {k: np_copy(v) for k, v in spec.items()}, rev))
                return super().window_pass_specs(segs, lengths, spec, rev)

        p = Params(file1path=os.path.join(ORACLE, "meg3sub64.fa"),
                   file2path=os.path.join(ORACLE, "MEG3.fa"))
        _, rna = fasta.read_rna(p.file2path)
        self.cap_eng = Recording(rna, device=self.dev)
        records = fasta.read_dna(p.file1path)
        t0 = time.perf_counter()
        hits = sum(len(x) for x in scan_records(p, records, rna,
                                                self.cap_eng))
        print(f"  captured {len(calls)} window dispatches from meg3sub64 "
              f"({hits} hits, {time.perf_counter() - t0:.1f} s)")
        require(any(c[3] for c in calls) and any(not c[3] for c in calls),
                "the candidate stage dispatched no forward or no reverse "
                "windows")
        return calls

    # -- phase 4 ---------------------------------------------------------

    def scan_for(self, driver: str):
        """The scan callable of fasim_tpu_torch.cli.run for a driver other
        than the CLI's own: the batched driver's round-robin over two
        engines (multi_devices), or per-segment (scan/pipeline.scan_file)
        or batched with TorchScanEngine(use_v2=False) on a cuda engine, as
        fasim_tpu_torch.verify runs them."""
        from fasim_tpu_torch import verify
        from fasim_tpu_torch.kernels.engine import TorchScanEngine
        from fasim_tpu_torch.scan.batched import scan_file_batched

        if driver == "round-robin":
            return lambda p, rna: scan_file_batched(
                p, [TorchScanEngine(rna, device=d)
                    for d in self.multi_devices()])
        return verify.scan_for(driver, self.dev)

    def run_cli(self, tmp: str, case: str, f1: str, f2: str, extra: list,
                driver: str = "cli", out: str = "out"):
        """The port's CLI (or cli.run with another driver's scan) in tmp on
        -f1 f1 -f2 f2 into tmp/out; returns (wall, stdout)."""
        from fasim_tpu_torch import cli

        os.mkdir(os.path.join(tmp, out))
        buf = io.StringIO()
        cwd = os.getcwd()
        os.chdir(tmp)
        argv = ["-f1", f1, "-f2", f2, "-O", f"{out}/",
                "--tpu-stdout-compat", "true", *extra]
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                if driver == "cli":
                    rc = cli.main(argv)
                else:
                    p, tpu = cli.parse_args(argv)
                    rc = cli.run(p, tpu, self.scan_for(driver))
            self.torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        require(rc == 0, f"{case}: exit {rc}")
        return wall, buf.getvalue()

    def run_golden(self, case: str, f1: str, f2: str, extra: list,
                   driver: str) -> float:
        import filecmp

        from fasim_tpu_torch.verify import expected_dir

        golden = expected_dir(case)
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copy(os.path.join(ORACLE, f1), tmp)
            shutil.copy(os.path.join(ORACLE, f2), tmp)
            wall, stdout = self.run_cli(tmp, case, f1, f2, extra, driver)
            produced = sorted(os.listdir(os.path.join(tmp, "out")))
            expected = sorted(f for f in os.listdir(golden)
                              if not f.startswith("stdout"))
            require(produced == expected,
                    f"{case}: files {produced} vs {expected}")
            for name in expected:
                require(filecmp.cmp(os.path.join(tmp, "out", name),
                                    os.path.join(golden, name),
                                    shallow=False),
                        f"{case}/{name} differs from the golden")

        [name] = [f for f in os.listdir(golden) if f.startswith("stdout")]
        with open(os.path.join(golden, name)) as f:
            require(stdout_lines(stdout) == stdout_lines(f.read()),
                    f"{case}: stdout differs from the golden")
        return wall

    @staticmethod
    def prewarm_counter():
        """Where scan/prewarm.py counts its warm launches (never in a
        wrapper's count)."""
        from fasim_tpu_torch.scan.prewarm import prewarm_engines

        return prewarm_engines

    def reset_counts(self) -> None:
        """Every launch count of the port's wrapper table
        (fasim_tpu_torch.kernels.WRAPPERS) and prewarm's at 0."""
        from fasim_tpu_torch.kernels import reset_launches

        reset_launches()
        self.prewarm_counter().launches = 0

    def read_counts(self) -> dict:
        from fasim_tpu_torch.kernels import read_launches

        return read_launches()

    K135 = ("scan_colmax", "window_fwd", "window_general")
    # every golden query is shorter than K3_MAX_M rows: no run takes the
    # long form of K4 and K6 (phase 5's 91 kb query does)
    LONG = ("window_general_long", "window_v1_long")
    SWITCHED = {"FASIM_SCAN16": "1", "FASIM_WIN_V1": "1"}
    STREAM = ["--tpu-stream", "on"]
    SIM_DEVICE = {"FASIM_SIM_DEVICE": "1"}
    NO_PREWARM = {"FASIM_PREWARM": "0"}
    # flag cases of fasim_tpu_torch.verify, held against the JAX package's
    # outputs (oracle/jax_expected): T = 2 (K7 packs a single pair), and
    # 5 segments of ~2,000 nt (N and n_pad of K1 and the windows)
    R3_T1 = ["-lg", "40", "-r", "3", "-t", "1"]
    C2000 = ["-lg", "40", "-c", "2000", "-o", "50"]
    K8 = ("scan_colmax", "sim_forward")
    # (golden case, DNA, RNA, extra flags, driver, environment, kernels of
    # its path, kernels it must not launch, whether it is a main path whose
    # counts the report gives: True for all of its kernels, or a tuple of
    # them).  A run launches sim_forward exactly when its kernels name it
    # (golden_case).
    GOLDENS = (
        ("h19_lg40", "testDNA.fa", "H19.fa", ["-lg", "40"], "cli", {}, K135,
         LONG, False),
        ("h19_lg40", "testDNA.fa", "H19.fa", ["-lg", "40"], "cli",
         {"FASIM_WIN_V3": "0"}, ("scan_colmax", "window_general"),
         ("window_fwd",) + LONG, False),
        # prewarm off: the default run's bytes and launch counts
        ("h19_lg40", "testDNA.fa", "H19.fa", ["-lg", "40"], "cli",
         NO_PREWARM, K135, LONG, False),
        ("h19_default", "testDNA.fa", "H19.fa", [], "cli", {}, K135, LONG,
         False),
        ("flags_r3_t1", "testDNA.fa", "H19.fa", R3_T1, "cli", {}, K135, LONG,
         False),
        ("flags_r3_t1", "testDNA.fa", "H19.fa", R3_T1, "cli", SWITCHED,
         ("scan_colmax16", "window_v1"), K135 + LONG, False),
        ("flags_c2000", "testDNA.fa", "H19.fa", C2000, "cli", {}, K135, LONG,
         False),
        ("h19F_trunc", "testDNAt.fa", "H19t.fa", ["-F", "-lg", "40"], "cli",
         {}, ("scan_colmax",), (), False),
        ("h19_lg40", "testDNA.fa", "H19.fa", ["-lg", "40"], "batched-v1",
         {}, ("scan_codes_colmax", "window_fwd", "window_general"), LONG,
         False),
        ("meg3_sub16", "meg3sub16.fa", "MEG3.fa", [], "per-segment", {},
         ("scan_codes_colmax",), (), True),
        ("neat1", "testDNA.fa", "NEAT1.fa", [], "cli", {}, K135, LONG,
         False),
        ("malat1", "testDNA.fa", "MALAT1.fa", [], "cli", {}, K135, LONG,
         False),
        ("meg3_sub64", "meg3sub64.fa", "MEG3.fa", [], "cli", {}, K135, LONG,
         False),
        ("meg3_full", "meg3dna.fa", "MEG3.fa", [], "cli", SWITCHED,
         ("scan_colmax16", "window_v1"), K135 + LONG, True),
        ("meg3_full", "meg3dna.fa", "MEG3.fa", STREAM, "cli", {}, K135,
         LONG, False),
        ("h19F_trunc", "testDNAt.fa", "H19t.fa",
         ["-F", "-lg", "40", *STREAM], "cli", {}, ("scan_colmax",), (),
         False),
        # -F with the forward scan on K8 and the host replay: batched under
        # the switch (h19_F's run is the report's K8 launches), streamed
        # under the flag
        ("h19F_trunc", "testDNAt.fa", "H19t.fa", ["-F", "-lg", "40"], "cli",
         SIM_DEVICE, K8, (), False),
        ("h19_F", "testDNA.fa", "H19.fa", ["-F", "-lg", "40"], "cli",
         SIM_DEVICE, K8, (), ("sim_forward",)),
        ("h19_F", "testDNA.fa", "H19.fa",
         ["-F", "-lg", "40", "--tpu-sim-device", "true", *STREAM], "cli", {},
         K8, (), False),
    )
    # the default MEG3-full run, the main path of K1, K3 and K4: phase 8
    # drives it under torch.profiler
    MEG3_FULL = ("meg3_full", "meg3dna.fa", "MEG3.fa", [], "cli", {}, K135,
                 LONG, True)

    @staticmethod
    @contextlib.contextmanager
    def driver_calls():
        """Count the calls of the CLI's two file drivers in the block."""
        import collections

        from fasim_tpu_torch.scan import batched

        calls = collections.Counter()
        saved = {name: getattr(batched, name)
                 for name in ("scan_file_batched", "scan_file_stream")}
        for name, fn in saved.items():
            def counted(*args, _fn=fn, _name=name, **kw):
                calls[_name] += 1
                return _fn(*args, **kw)

            setattr(batched, name, counted)
        try:
            yield calls
        finally:
            for name, fn in saved.items():
                setattr(batched, name, fn)

    def golden_case(self, case: str, f1: str, f2: str, extra: list,
                    driver: str, env: dict, kernels: tuple, off: tuple,
                    main: bool, note: str = "") -> None:
        """One entry of GOLDENS: its run against the golden with the counts
        set to 0 just before it and read just after, its kernels launched,
        those of `off` not, the driver its flags pick, no spill file left;
        its wall kept, and its counts too where it is a main path.  Every
        run without K8 in its kernels must not launch it.  The environment
        is put back after the run (`--tpu-sim-device true` sets
        FASIM_SIM_DEVICE=1 in the CLI's process)."""
        if "sim_forward" not in kernels:
            off = (*off, "sim_forward")
        stream = "--tpu-stream" in extra
        flags = "".join(f", {k}={v}" for k, v in env.items())
        sim_dev = ", --tpu-sim-device true" if "--tpu-sim-device" in extra \
            else ""
        run = (f"{case} ({driver}{', --tpu-stream on' if stream else ''}"
               f"{sim_dev}{flags}){note}")
        with tempfile.TemporaryDirectory() as spill, kept_environment(), \
                switches(**env, FASIM_SPILL_DIR=spill), \
                self.driver_calls() as calls:
            self.reset_counts()
            wall = self.run_golden(case, f1, f2, extra, driver)
            counts = self.read_counts()
            warm = self.prewarm_counter().launches
            left = [f for f in os.listdir(spill)
                    if f.startswith("fasim-strspill-")]
        require(not left, f"{run}: spill files left behind: {left}")
        if driver == "cli":
            want = "scan_file_stream" if stream else "scan_file_batched"
            require(calls == {want: 1}, f"{run}: drivers run {calls}")
        print(f"  {run}: byte-identical, wall {wall:.3f} s, launches "
              f"{counts}, prewarm's {warm}")
        for k in kernels:
            require(counts[k] > 0, f"{run}: kernel {k} was never launched")
        for k in off:
            require(counts[k] == 0, f"{run}: kernel {k} was launched "
                    f"{counts[k]} times")
        self.walls[run] = wall
        self.counts[run] = counts
        if main:
            self.launches.update({k: counts[k] for k in
                                  (kernels if main is True else main)})

    def phase_e2e(self) -> None:
        for entry in self.GOLDENS:
            self.golden_case(*entry)
        warm, cold = (self.counts[f"h19_lg40 (cli{flags})"]
                      for flags in ("", ", FASIM_PREWARM=0"))
        require(warm == cold, f"h19_lg40: launches {warm} with prewarm, "
                f"{cold} without")
        h19 = {run: wall for run, wall in self.walls.items()
               if run.startswith(("h19_F ", "h19F_trunc "))}
        print("  -F walls, host SIM and device forward scan (K8): "
              + "; ".join(f"{run} {wall:.3f} s" for run, wall in h19.items()))

    # -- phase 5 ---------------------------------------------------------

    def multi_devices(self) -> list:
        """The devices of the two-engine runs: cuda:0 and cuda:1, or both
        on cuda:0 on a machine with one card."""
        if self.torch.cuda.device_count() >= 2:
            return ["cuda:0", "cuda:1"]
        return ["cuda:0", "cuda:0"]

    @staticmethod
    @contextlib.contextmanager
    def engine_batches(dispatch: str):
        """In the block, every TorchScanEngine built and the batches each
        one dispatched through `dispatch` (scan_segments_packed for
        fastSIM, scan_segments for -F, whose escalation reruns with
        full_prefix are not dispatches): yields a callable returning
        [(device, batches)] in the order the engines were built, which is
        the round-robin's.  Prewarm's calls on its own threads are not
        dispatches."""
        import threading

        from fasim_tpu_torch.kernels.engine import TorchScanEngine
        from fasim_tpu_torch.scan.prewarm import THREAD_NAME

        made, batches = [], {}
        init, call = TorchScanEngine.__init__, getattr(TorchScanEngine,
                                                       dispatch)

        def built(self, *args, **kw):
            init(self, *args, **kw)
            made.append(self)

        def counted(self, *args, **kw):
            if (not kw.get("full_prefix")
                    and threading.current_thread().name != THREAD_NAME):
                batches[id(self)] = batches.get(id(self), 0) + 1
            return call(self, *args, **kw)

        TorchScanEngine.__init__ = built
        setattr(TorchScanEngine, dispatch, counted)
        try:
            yield lambda: [(str(e.device), batches.get(id(e), 0))
                           for e in made]
        finally:
            TorchScanEngine.__init__ = init
            setattr(TorchScanEngine, dispatch, call)

    # (golden case, DNA, RNA, extra flags, driver, environment, kernels,
    # kernels not launched, the engines' dispatch method, engines): the
    # batched driver's round-robin; `--tpu-dp-devices 2` through the CLI
    # builds min(2, device_count()) engines
    MULTI = (
        ("meg3_full", "meg3dna.fa", "MEG3.fa", [], "round-robin", {}, K135,
         LONG, "scan_segments_packed", 2),
        ("meg3_sub64", "meg3sub64.fa", "MEG3.fa", ["--tpu-dp-devices", "2"],
         "cli", {}, K135, LONG, "scan_segments_packed", None),
        ("h19F_trunc", "testDNAt.fa", "H19t.fa", ["-F", "-lg", "40"],
         "round-robin", SIM_DEVICE, K8, (), "scan_segments", 2),
    )

    def phase_multi(self) -> None:
        """Multi-GPU and multi-host on the card: MEG3-full through the
        batched driver's round-robin over two engines (cuda:0 and cuda:1,
        or both on cuda:0), meg3_sub64 through the CLI under
        `--tpu-dp-devices 2`, h19F_trunc (-F) on K8 over two engines, each
        byte-identical with its kernels launched and engine i dispatching
        batches i, i + n, ... of the run; then MEG3-full through two `fasim_tpu_torch.dist.runner` processes over
        gloo (byte-identical, then again from the checkpoint spills with
        no kernel launched), and dryrun_multichip on the two devices."""
        torch = self.torch
        print(f"  device_count() {torch.cuda.device_count()}, two-engine "
              f"devices {self.multi_devices()}, on {self.smi}")
        for (case, f1, f2, extra, driver, env, kernels, off, dispatch,
             n) in self.MULTI:
            with self.engine_batches(dispatch) as split:
                self.golden_case(
                    case, f1, f2, extra, driver, env, kernels, off, False,
                    " --tpu-dp-devices 2" if "--tpu-dp-devices" in extra
                    else "")
                got = split()
            n = n or min(2, torch.cuda.device_count())
            total = sum(b for _, b in got)
            want = [len(range(i, total, n)) for i in range(n)]
            require(len(got) == n and [b for _, b in got] == want,
                    f"{case} ({driver}, {extra}): engines and batches {got}, "
                    f"want {n} engines with {want}")
            print(f"    engines (device, batches): {got}")
        self.runner_phase()
        from fasim_tpu_torch.dist.dryrun import dryrun_multichip

        self.reset_counts()
        t0 = time.perf_counter()
        print("  " + dryrun_multichip(self.multi_devices()))
        counts = self.read_counts()
        for k in self.DRYRUN_KERNELS:
            require(counts[k] > 0, f"dryrun_multichip: kernel {k} was "
                    "never launched")
        print(f"    {time.perf_counter() - t0:.3f} s, launches {counts}")

    # one dist.runner process, then on stderr its launch counts and its
    # local and gather seconds
    RUNNER_RUN = """
import json
import sys

from fasim_tpu_torch.dist import runner
from fasim_tpu_torch.kernels import read_launches

rc = runner.main(sys.argv[1:])
print("LAUNCHES " + json.dumps(read_launches()), file=sys.stderr)
print("SECONDS " + json.dumps({"local": runner.LAST_LOCAL_SECONDS,
                               "gather": runner.LAST_GATHER_SECONDS}),
      file=sys.stderr)
sys.exit(rc)
"""
    RUNNER_TIMEOUT_S = 300
    # (golden case, DNA, RNA) of the runner's processes
    RUNNER_CASE = ("meg3_full", "meg3dna.fa", "MEG3.fa")
    # the dry run's scans (K1), sharded step (K5) and forward windows (K3)
    DRYRUN_KERNELS = ("scan_colmax", "scan_codes_colmax", "window_fwd")

    def runner_phase(self) -> None:
        """MEG3-full through two runner processes (rank r on the card r
        mod device_count() via CUDA_VISIBLE_DEVICES, gloo over loopback, a
        fresh FASIM_CKPT): rank 0's files byte-identical to the golden,
        K1, K3 and K4 launched in each; then the outputs wiped and the
        run repeated from the spills: the same bytes, no kernel launched."""
        import filecmp
        import socket

        case, f1, f2 = self.RUNNER_CASE
        golden = os.path.join(ORACLE, "golden", case)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = (visible.split(",") if visible else
                 [str(i) for i in range(self.torch.cuda.device_count())])
        with tempfile.TemporaryDirectory() as tmp:
            for f in (f1, f2):
                shutil.copy(os.path.join(ORACLE, f), tmp)
            out = os.path.join(tmp, "out")
            os.mkdir(out)
            ckpt = os.path.join(tmp, "ckpt")
            for rerun in (False, True):
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                run = (f"{case} (dist.runner, 2 processes"
                       + (", from the spills)" if rerun else ")"))
                t0 = time.perf_counter()
                procs = []
                for rank in range(2):
                    env = dict(os.environ, PYTHONPATH=REPO,
                               CUDA_VISIBLE_DEVICES=cards[rank % len(cards)],
                               FASIM_COORD=f"127.0.0.1:{port}",
                               FASIM_NPROC="2", FASIM_PID=str(rank),
                               FASIM_CKPT=ckpt, GLOO_SOCKET_IFNAME="lo")
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", self.RUNNER_RUN, "-f1", f1,
                         "-f2", f2, "-O", "out/", "--tpu-engine", "cuda"],
                        cwd=tmp, env=env,
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True))
                try:
                    outs = [pr.communicate(timeout=self.RUNNER_TIMEOUT_S)
                            for pr in procs]
                finally:
                    for pr in procs:
                        if pr.poll() is None:
                            pr.kill()
                            pr.wait()
                wall = time.perf_counter() - t0
                for rank, (pr, (stdout, stderr)) in enumerate(
                        zip(procs, outs)):
                    require(pr.returncode == 0, f"{run}: rank {rank} exit "
                            f"{pr.returncode}: {stderr[-3000:]}")
                tags = [{ln.partition(" ")[0]: json.loads(
                    ln.partition(" ")[2]) for ln in err.splitlines()
                    if ln.startswith(("LAUNCHES ", "SECONDS "))}
                    for _, err in outs]
                require("finished normally" in outs[0][0],
                        f"{run}: rank 0 did not finish normally")
                names = sorted(os.listdir(out))
                expected = sorted(f for f in os.listdir(golden)
                                  if not f.startswith("stdout"))
                require(names == expected, f"{run}: files {names}")
                for name in names:
                    require(filecmp.cmp(os.path.join(out, name),
                                        os.path.join(golden, name),
                                        shallow=False),
                            f"{run}: {name} differs from the golden")
                for rank, tag in enumerate(tags):
                    counts = tag["LAUNCHES"]
                    if rerun:
                        require(not any(counts.values()),
                                f"{run}: rank {rank} launched {counts}")
                    else:
                        for k in self.K135:
                            require(counts[k] > 0, f"{run}: rank {rank} "
                                    f"never launched {k}")
                    print(f"  {run}: rank {rank} on card "
                          f"{cards[rank % len(cards)]}: local "
                          f"{tag['SECONDS']['local']:.3f} s, gather "
                          f"{tag['SECONDS']['gather']:.3f} s, launches "
                          f"{counts}")
                print(f"  {run}: byte-identical, wall {wall:.3f} s")
                self.walls[run] = wall
                for name in names:
                    os.unlink(os.path.join(out, name))
                require(os.listdir(ckpt), f"{run}: no checkpoint spill")

    # -- phase 6 ---------------------------------------------------------

    # one CLI run in its own process, then on stderr the launch counts of
    # its kernels, the drivers it ran and its peak resident set (Linux:
    # ru_maxrss in KiB)
    GENOME_RUN = """
import json
import resource
import sys

import chip_smoke
from fasim_tpu_torch import cli
from fasim_tpu_torch.kernels import read_launches

with chip_smoke.Smoke.driver_calls() as calls:
    rc = cli.main(sys.argv[1:])
print("LAUNCHES " + json.dumps(read_launches()), file=sys.stderr)
print("DRIVERS " + json.dumps(calls), file=sys.stderr)
print("PEAK_RSS_MB " + json.dumps(
    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024),
      file=sys.stderr)
sys.exit(rc)
"""
    GENOME_TIMEOUT_S = 540
    RSS_EVERY_S = 2

    def phase_genome(self) -> None:
        """The synthetic genome (GENOME_MB of random ACGT, past the CLI's
        32 MiB `--tpu-stream auto` threshold) with MEG3 through the CLI in
        its own process under `auto`, which streams: it exits 0, launches
        K1, K3 and K4 and not the long-query kernels, leaves no spill file
        and writes TFOsorted rows.  Then a smaller genome from the same
        generator (SMALL_GENOME_MB, seed 0, two records) under `--tpu-stream
        on` and `off`, each in its own process: the same checks, and the
        same bytes in every output file and on stdout.  Each run's wall,
        Mb/s, stage split and peak RSS are kept for the lines printed
        before the last."""
        import filecmp

        from fasim_tpu_torch import cli
        from fasim_tpu_torch.config import TpuConfig
        from fasim_tpu_torch.io import fasta

        self.genome = []
        with tempfile.TemporaryDirectory() as tmp:
            _, rna = fasta.read_rna(os.path.join(ORACLE, "MEG3.fa"))
            shutil.copy(os.path.join(ORACLE, "MEG3.fa"), tmp)
            for name, mb in (("genome.fa", GENOME_MB),
                             ("genome_small.fa", SMALL_GENOME_MB)):
                path = os.path.join(tmp, name)
                t0 = time.perf_counter()
                bases = synth_genome(path, mb, rna, GENOME_SEED)
                print(f"  {name}: {bases} bases in "
                      f"{-(-bases // 5_000_000)} records, "
                      f"{os.path.getsize(path)} bytes, written in "
                      f"{time.perf_counter() - t0:.1f} s")
            size = os.path.getsize(os.path.join(tmp, "genome.fa"))
            require(cli.wants_stream(TpuConfig(stream="auto"),
                                     os.path.join(tmp, "genome.fa")),
                    f"--tpu-stream auto does not stream {size} bytes")
            self.genome_run(tmp, "genome.fa", "auto", GENOME_MB)
            outs = {mode: self.genome_run(tmp, "genome_small.fa", mode,
                                          SMALL_GENOME_MB)
                    for mode in ("on", "off")}
            dirs = {mode: os.path.join(tmp, f"out_genome_small_{mode}")
                    for mode in outs}
            names = sorted(os.listdir(dirs["on"]))
            require(names == sorted(os.listdir(dirs["off"]))
                    and len(names) == 3, f"genome: output files {names}")
            for name in names:
                require(filecmp.cmp(os.path.join(dirs["on"], name),
                                    os.path.join(dirs["off"], name),
                                    shallow=False),
                        f"genome: {name} differs between on and off")
            require(outs["on"] == outs["off"],
                    "genome: stdout differs between on and off")
            print(f"  genome_small.fa: --tpu-stream on and off "
                  f"byte-identical ({len(names)} files and stdout)")

    def genome_run(self, tmp: str, fa: str, mode: str, mb: float) -> list:
        """One `--tpu-stream mode` CLI process on `fa` (mb Mb): its stdout;
        its output files go to out_<fa's stem>_<mode>/.  It must exit 0,
        go through the driver `mode` picks, launch K1, K3 and K4 and not
        the long-query kernels, leave no spill file and write TFOsorted
        rows."""
        stem = f"{os.path.splitext(fa)[0]}_{mode}"
        spill = os.path.join(tmp, f"spill_{stem}")
        out_dir = os.path.join(tmp, f"out_{stem}")
        os.mkdir(spill)
        os.mkdir(out_dir)
        env = dict(os.environ, PYTHONPATH=REPO, FASIM_SPILL_DIR=spill)
        run = f"{fa} --tpu-stream {mode}"
        rss = []  # the process's resident set (MB), every RSS_EVERY_S
        t0 = time.perf_counter()
        with tempfile.TemporaryFile("w+") as out, \
                tempfile.TemporaryFile("w+") as err:
            proc = subprocess.Popen(
                [sys.executable, "-c", self.GENOME_RUN, "-f1", fa,
                 "-f2", "MEG3.fa", "-O", f"out_{stem}/", "--tpu-profile",
                 "true", "--tpu-stream", mode], cwd=tmp, env=env,
                stdout=out, stderr=err, text=True)
            try:
                while proc.poll() is None:
                    require(time.perf_counter() - t0 < self.GENOME_TIMEOUT_S,
                            f"{run}: no end in {self.GENOME_TIMEOUT_S} s")
                    rss.append(vm_rss_mb(proc.pid))
                    try:
                        proc.wait(timeout=self.RSS_EVERY_S)
                    except subprocess.TimeoutExpired:
                        pass
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            wall = time.perf_counter() - t0
            out.seek(0)
            err.seek(0)
            stdout, stderr = out.read(), err.read()
        require(proc.returncode == 0,
                f"{run}: exit {proc.returncode}: {stderr[-3000:]}")
        tagged = {}
        for line in stderr.splitlines():
            tag, _, rest = line.partition(" ")
            if tag in ("FASIM_PROFILE", "LAUNCHES", "DRIVERS", "PEAK_RSS_MB"):
                tagged[tag] = json.loads(rest)
        prof, counts = tagged["FASIM_PROFILE"], tagged["LAUNCHES"]
        streamed = mode in ("auto", "on")
        want = "scan_file_stream" if streamed else "scan_file_batched"
        require(tagged["DRIVERS"] == {want: 1},
                f"{run}: drivers run {tagged['DRIVERS']}")
        for k in self.K135:
            require(counts[k] > 0, f"{run}: kernel {k} was never launched")
        for k in self.LONG:
            require(counts[k] == 0, f"{run}: kernel {k} was launched")
        left = os.listdir(spill)
        require(not left, f"{run}: spill files left behind: {left}")
        [tfo] = [f for f in os.listdir(out_dir) if f.endswith("-TFOsorted")]
        with open(os.path.join(out_dir, tfo)) as f:
            rows = sum(1 for _ in f) - 1
        require(rows > 0, f"{run}: the TFOsorted holds no row")
        split = {k: v for k, v in prof.items() if not k.startswith("n_")}
        quarters = [round(max(rss[:max(1, len(rss) * q // 4)], default=0))
                    for q in (1, 2, 3, 4)]
        self.genome.append(
            f"genome {mb:g} Mb x MEG3, --tpu-stream {mode} "
            f"({'streaming' if streamed else 'batched'} driver): wall "
            f"{wall:.3f} s for the process ({prof['wall']} s in its run), "
            f"{mb / wall:.4f} Mb/s, {rows} TFOsorted rows, peak RSS "
            f"{tagged['PEAK_RSS_MB']:.1f} MB (ru_maxrss of the process; the "
            f"largest VmRSS sampled by the end of each quarter of the "
            f"run {quarters} MB), launches {counts}, stages "
            f"{json.dumps(split)} on {self.smi}")
        print("  " + self.genome[-1])
        return stdout.splitlines()

    # -- phase 7 ---------------------------------------------------------

    def phase_times(self) -> None:
        self.k1_times()
        self.window_times()
        self.k5_times()
        self.k8_times()
        for name, regs in ptxas_registers().items():
            print(f"  ptxas registers {short_name(name)}: {regs}")

    def window_times(self) -> None:
        """K3, K4 and K6 on the largest forward and reverse window dispatch
        of a real candidate stage, and the long forms of K4 and K6 called
        directly on the same dispatches (like for like; phase 9 times them
        on the 91 kb query's)."""
        np = self.np
        from fasim_tpu_torch.kernels.window import (window_fwd,
                                                    window_general,
                                                    window_general_long,
                                                    window_pass_ref)
        from fasim_tpu_torch.kernels.window_v1 import (v1_ends, window_v1,
                                                       window_v1_long)

        # the largest forward and reverse dispatch of the meg3sub64 batch;
        # K6's numbers are those of both dispatches
        k6 = {"ms": 0.0, "long": 0.0, "plain": 0.0, "ops": 0.0, "bytes": 0}
        for kernel, rev in (("window_fwd", False), ("window_general", True)):
            calls = [c for c in self.capture if c[3] == rev]
            segs_c, lens_c, spec, _ = max(calls,
                                          key=lambda c: len(c[2]["rlens"]))
            parts = self.spec_codes(self.cap_eng, segs_c, lens_c, spec, rev)
            qp = self.cap_eng._dev["qwin_rev" if rev else "qwin_fwd"]
            tab = self.cap_eng._dev["wtab_rev" if rev else "wtab_fwd"]
            m, m16 = self.cap_eng.m, self.cap_eng.m16
            qc = self.cap_eng._qcodes(rev)

            def run(how, parts=parts, qp=qp, tab=tab, qc=qc):
                for _, codes, part in parts:
                    args = (codes, qp, part["offs"], part["terms"],
                            part["rlens"], part["mreals"], m)
                    v1_args = (codes, qc, *args[2:])
                    if how == "window_v1":
                        window_v1(*v1_args, tab)
                    elif how == "window_v1_long":
                        window_v1_long(*v1_args, tab)
                    elif how == "v1_plain":
                        v1_ends(*v1_args)
                    elif how == "plain":
                        window_pass_ref(*args)
                    elif how == "window_general":
                        window_general(*args, tab)
                    elif how == "window_general_long":
                        window_general_long(*args, tab)
                    else:
                        window_fwd(codes, qp, tab, part["rlens"], m, m16)

            self.ms[kernel] = self.cuda_ms(lambda: run(kernel), 5)
            self.plain_ms[kernel] = self.cuda_ms(lambda: run("plain"), 1,
                                                 warm=False)
            # the rows each window needs: [off, max(mreal, m)) x rlen
            rl = spec["rlens"].astype(np.int64)
            top = np.maximum(spec["mreals"], m).astype(np.int64)
            cells = int((rl * (top - spec["offs"])).sum())
            rows = len(rl)
            code_bytes = sum(int(c.numel()) for _, c, _ in parts)
            self.work[kernel] = (WINDOW_OPS_PER_CELL * cells,
                                 code_bytes + rows * (16 if rev else 4)
                                 + rows * 12 + 12 * m)
            widths = {W: int(c.shape[0]) for W, c, _ in parts}
            print(f"  {kernel}, {'reverse' if rev else 'forward'} dispatch "
                  f"of {rows} rows (rows per width {widths}), "
                  f"m={m}: kernel {self.ms[kernel]:.3f} ms, plain "
                  f"{self.plain_ms[kernel]:.3f} ms")
            edges = (0, 16, 32, 48, 64, 128, 256)
            # bins (a, b] of the integer lengths: np.histogram's [a + 1,
            # b + 1)
            hist = np.histogram(rl, bins=np.add(edges, 1))[0]
            print("  rlen histogram of the dispatch: " + ", ".join(
                f"({a}, {b}] {int(n)}" for a, b, n in zip(
                    edges, edges[1:], hist)))
            k4_long = self.cuda_ms(lambda: run("window_general_long"), 5)
            if not rev:
                # the same specs (off 0, terms -1, mreals m16) on K4
                k4_ms = self.cuda_ms(lambda: run("window_general"), 5)
                k6_ms = self.cuda_ms(lambda: run("window_v1"), 5)
                print(f"  K3 window_fwd {self.ms[kernel]:.3f} ms against "
                      f"K4 (window_general) {k4_ms:.3f} ms and its long form "
                      f"(window_general_long) {k4_long:.3f} ms on the same "
                      "dispatch")
            else:
                k4_ms = self.ms[kernel]
                k6_ms = self.cuda_ms(lambda: run("window_v1"), 5)
                print(f"  K4 window_general {k4_ms:.3f} ms against its long "
                      f"form (window_general_long, called directly) "
                      f"{k4_long:.3f} ms = {k4_long / k4_ms:.3f}x on the "
                      "same dispatch")
                self.k4_sweep(spec, parts, qp, tab, m, cells)
            # K6 on the same dispatch: its kernel beside K4's, and its long
            # form called directly
            k6_long = self.cuda_ms(lambda: run("window_v1_long"), 5)
            k6["ms"] += k6_ms
            k6["long"] += k6_long
            k6["plain"] += self.cuda_ms(lambda: run("v1_plain"), 1,
                                        warm=False)
            k6["ops"] += WINDOW_OPS_PER_CELL * cells
            k6["bytes"] += code_bytes + rows * 28 + 8 * int(qc.numel())
            print(f"  K6 window_v1, the same dispatch: {k6_ms:.3f} ms = "
                  f"{k6_ms / k4_ms:.3f}x K4's window_general ({k4_ms:.3f} "
                  f"ms); its long form (window_v1_long, called directly) "
                  f"{k6_long:.3f} ms = {k6_long / k6_ms:.3f}x")
        self.ms["window_v1"] = k6["ms"]
        self.plain_ms["window_v1"] = k6["plain"]
        self.work["window_v1"] = (k6["ops"], k6["bytes"])
        print(f"  K6 window_v1 on both dispatches {k6['ms']:.3f} ms, its "
              f"long form {k6['long']:.3f} ms")
        self.print_pair_registers()

    def print_pair_registers(self) -> None:
        """ptxas registers of K4's and K6's pair kernels, both forms."""
        pairs = sorted((short_name(e), r) for e, r in
                       ptxas_registers().items()
                       if "window_pairs_kernel" in e)
        for policy, name in ((0, "K4"), (1, "K6")):
            for form, label in ((0, "16-bit row keys"), (1, "long form")):
                print(f"  ptxas registers {name}, {label} (window_pairs_kernel"
                      " at 64 / 128 / 256 columns): " + " / ".join(
                          str(r) for e, r in pairs
                          if e.endswith(f"Lb{policy}ELb{form}E")))

    def k1_times(self) -> None:
        """K1 on the main-path batch of phase 3: its ssw pass against the
        plain version, its rates, its threshold pass, K1 at NEAT1 length;
        K7 on the same ssw pass; the candidate packing of its output."""
        torch = self.torch
        from fasim_tpu_torch.kernels.pack import pack_candidates
        from fasim_tpu_torch.kernels.scan import (
            decode_bases, scan_colmax, scan_colmax16, scan_colmax16_ref,
            scan_colmax_ref)

        rna, segs, lens = self.main_k1
        eng = self.engine(rna)
        d = eng._dev
        segs_d = torch.from_numpy(segs).to(self.dev)
        lens_d = torch.from_numpy(lens).to(self.dev)
        bases, bases_rev = decode_bases(segs_d, lens_d)
        args = (bases, bases_rev, d["lut6_s"], d["istr"], d["qp2_ssw"],
                eng.m16, False)
        k1_args = (*args[:5], d["stab_ssw"], *args[5:])
        self.ms["scan_colmax"] = self.cuda_ms(lambda: scan_colmax(*k1_args),
                                              3)
        self.plain_ms["scan_colmax"] = self.cuda_ms(
            lambda: scan_colmax_ref(*args), 1, warm=False)
        S, N = segs.shape
        T = d["lut6_s"].shape[0]
        cells = S * T * N * eng.m16
        self.work["scan_colmax"] = (
            scan_ops_per_cell(eng.m16, N) * cells,
            2 * S * N + S * T * N + 4 * S * T + 4 * T * 7 + 16 * eng.m16)
        print(f"  K1 scan_colmax, ssw pass, S={S} T={T} N={N} m={len(rna)}: "
              f"kernel {self.ms['scan_colmax']:.3f} ms, plain "
              f"{self.plain_ms['scan_colmax']:.3f} ms")
        self.scan_rates(K1_SCAN, eng.m16, N, S * T, cells,
                        self.ms["scan_colmax"])
        thr_args = (bases, bases_rev, d["lut6_t"], d["istr"],
                    d["qp2_thresh"], d["stab_thresh"], eng.m16, True)
        thr_ms = self.cuda_ms(lambda: scan_colmax(*thr_args, want_cm=False),
                              3)
        print(f"  K1 scan_colmax, threshold-alphabet pass (thresholds only),"
              f" the same batch: kernel {thr_ms:.3f} ms ("
              f"{cells / thr_ms / 1e6:.1f} G cells/s; bound "
              f"{self.bound(*self.work['scan_colmax'])[0]:.3f} ms)")
        k7_args = (*args[:5], d["stab16_ssw"], *args[5:])
        self.ms["scan_colmax16"] = self.cuda_ms(
            lambda: scan_colmax16(*k7_args), 3)
        self.plain_ms["scan_colmax16"] = self.cuda_ms(
            lambda: scan_colmax16_ref(*args), 1, warm=False)
        self.work["scan_colmax16"] = self.work["scan_colmax"]
        k7_ms = self.ms["scan_colmax16"]
        print(f"  K7 scan_colmax16, the same pass: kernel {k7_ms:.3f} ms "
              f"({k7_ms / self.ms['scan_colmax']:.3f}x K1's), plain "
              f"{self.plain_ms['scan_colmax16']:.3f} ms; bound "
              f"{self.bound(*self.work['scan_colmax16'])[0]:.3f} ms")
        self.scan_rates(K7_SCAN, eng.m16, N, S * T, cells, k7_ms)
        thr7_args = (*thr_args[:5], d["stab16_thresh"], *thr_args[6:])
        thr7_ms = self.cuda_ms(
            lambda: scan_colmax16(*thr7_args, want_cm=False), 3)
        print(f"  K7 scan_colmax16, threshold-alphabet pass (thresholds "
              f"only), the same batch: kernel {thr7_ms:.3f} ms")
        self.scan_neat1(bases, bases_rev, S, T, N)
        cm, gm = scan_colmax(*k1_args)
        pack_ms = self.cuda_ms(
            lambda: pack_candidates(gm, cm, lens_d, eng.PACK_K), 5)
        print(f"  pack_candidates (torch ops) on that batch: {pack_ms:.3f} ms")

    def scan_rates(self, kern: ScanKernel, m16: int, N: int, pairs: int,
                   cells: int, ms: float) -> None:
        """A scan kernel's rates on a timed pass: G cells/s; the SASS count
        of the step loop of the instantiation launched at m16 (sass_loop;
        one iteration a step, a lane's `rows` rows of one cell a pair its
        warp sweeps), a cell and in integer operations, and the integer
        ops/s the loop executes at that time; the count of its column block
        alone (the cells' instructions and the column's fetch); its
        resident warps an SM (the CUDA occupancy calculator) with the waves
        of the batch's warps (`pairs` / kern.pairs_a_warp)."""
        from fasim_tpu_torch.kernels import scan

        name = kern.name
        rows = scan.kernel_rows(m16)
        per = kern.pairs_a_warp * rows  # cells a lane a step
        sass = sass_loop(f"{kern.entry}ILi{rows}E")
        sms = self.torch.cuda.get_device_properties(0).multi_processor_count
        warps = getattr(scan, kern.blocks)(m16, N)
        launched = pairs // kern.pairs_a_warp
        print(f"  {name} SASS at {rows} rows a lane: step loop "
              f"{sass['loop']} instructions, {sass['loop'] / per:.2f} a "
              f"cell, of them {sass['loop_integer']} integer operations, "
              f"{sass['loop_integer'] / per:.2f} a cell; its column block "
              f"{sass['block']} for {sass['cells']} rows' cells, "
              f"{sass['block'] / per:.2f} a cell, "
              f"{sass['integer'] / per:.2f} integer and "
              f"{sass['moves'] / per:.2f} moves, the cells' own "
              f"{sass['cell_ops'] / per:.2f}; block by opcode "
              + ", ".join(f"{k} {v}" for k, v in sass["opcodes"].items()))
        loop_ops = cells * sass["loop_integer"] / per / ms * 1e3
        block_ops = cells * sass["integer"] / per / ms * 1e3
        print(f"  {name} rates: {cells / ms / 1e6:.1f} G cells/s, "
              f"{loop_ops:.4g} integer ops/s in the step loop "
              f"({block_ops:.4g} in its column block; int32 rate "
              f"{self.int32_ops:.4g}); {warps} resident warps an SM, "
              f"{launched} warps = {launched / (warps * sms):.3f} waves on "
              f"{sms} SMs; int32-form floor (7 a cell) "
              f"{self.bound(7 * cells, 0)[0]:.3f} ms")

    def scan_neat1(self, bases, bases_rev, S: int, T: int, N: int) -> None:
        """K1 and K7 at NEAT1 length (m = 22,767, 45 strips; inside K7's
        gate, 5 * min(22,768, 5,120) = 25,600) on the full 64-segment
        batch, ssw pass, kernel only (the plain versions would take
        minutes; phase 3 holds both against them at this length), against
        their bound, and K7's outputs against K1's."""
        from fasim_tpu_torch.kernels.scan import (in_gate16, scan_colmax,
                                                  scan_colmax16)

        eng = self.engine(self.dna(NEAT1_M))
        d = eng._dev
        args = (bases, bases_rev, d["lut6_s"], d["istr"], d["qp2_ssw"],
                d["stab_ssw"], eng.m16, False)
        ms = self.cuda_ms(lambda: scan_colmax(*args), 2)
        cells = S * T * N * eng.m16
        ops = scan_ops_per_cell(eng.m16, N)
        bound_ms, term = self.bound(ops * cells, 0)
        print(f"  K1 scan_colmax at NEAT1 length, S={S} T={T} N={N} "
              f"m={NEAT1_M} (m16 {eng.m16}), ssw pass: kernel {ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms ({term}, {ops} a cell), int32-form "
              f"floor (7 a cell) {self.bound(7 * cells, 0)[0]:.3f} ms, "
              f"{cells / ms / 1e6:.1f} G cells/s")
        self.scan_rates(K1_SCAN, eng.m16, N, S * T, cells, ms)
        require(in_gate16(T, eng.m16, N), "NEAT1 length: outside K7's gate")
        args7 = (*args[:5], d["stab16_ssw"], *args[6:])
        ms7 = self.cuda_ms(lambda: scan_colmax16(*args7), 2)
        got, want = scan_colmax16(*args7), scan_colmax(*args)
        self.torch.cuda.synchronize()
        require(all(self.torch.equal(a, b) for a, b in zip(got, want)),
                "K7 at NEAT1 length differs from K1")
        print(f"  K7 scan_colmax16 at NEAT1 length, the same pass: kernel "
              f"{ms7:.3f} ms ({ms7 / ms:.3f}x K1's), bound {bound_ms:.3f} "
              f"ms, {cells / ms7 / 1e6:.1f} G cells/s; outputs equal to "
              "K1's")
        self.scan_rates(K7_SCAN, eng.m16, N, S * T, cells, ms7)

    def k4_sweep(self, spec, parts, qp, tab, m: int, cells: int) -> None:
        """What K4's 16-bit kernel sweeps on a dispatch, from the wrapper's
        pair order: the histogram of the spans max(mreal, m) - off, that of
        the offset mismatches within pairs, and per width class its time
        (the wrapper), its bound and the cells it sweeps (both halves of
        every pair: its columns x its rows from the lower offset) against
        the cells its bound counts."""
        np = self.np
        from fasim_tpu_torch.kernels.window import (K4_SHORT, offset_order,
                                                    window_general)

        span = np.maximum(spec["mreals"], m) - np.maximum(spec["offs"], 0)
        edges = (0, 64, 256, 512, 1024, 2048, 1 << 17)
        hist = np.histogram(span, bins=np.add(edges, 1))[0]  # (a, b]
        print("  span histogram of the reverse dispatch: " + ", ".join(
            f"({a}, {b}] {int(n)}" for a, b, n in zip(edges, edges[1:],
                                                       hist)))
        gaps, swept_all = [], 0
        for W, codes, part in parts:
            offs = np.maximum(part["offs"].cpu().numpy(), 0)
            top = np.maximum(part["mreals"].cpu().numpy(), m)
            rl = part["rlens"].cpu().numpy().astype(np.int64)
            need = int((rl * (top - offs)).sum())
            order, n_first = offset_order(part["rlens"], part["offs"], m,
                                          K4_SHORT[W])
            order = order.cpu().numpy()
            n = int(n_first)
            swept = 0
            for group, cols in ((order[:n], K4_SHORT[W]), (order[n:], W)):
                a, b = group[0::2], group[1::2]
                b = np.concatenate([b, a[len(b):]])  # a lone last window
                gaps.append(np.abs(offs[a] - offs[b]))
                swept += 2 * cols * int((np.maximum(top[a], top[b])
                                         - np.minimum(offs[a], offs[b])).sum())
            swept_all += swept
            args = (codes, qp, part["offs"], part["terms"], part["rlens"],
                    part["mreals"], m, tab)
            ms = self.cuda_ms(lambda: window_general(*args), 5)
            bound_ms = self.bound(WINDOW_OPS_PER_CELL * need, 0)[0]
            print(f"  K4 {W}-column class, {codes.shape[0]} rows: "
                  f"{ms:.3f} ms, bound {bound_ms:.3f} ms, cells swept "
                  f"{swept} against the bound's {need} "
                  f"({swept / max(need, 1):.3f}x)")
        gaps = np.concatenate(gaps)
        edges = (0, 1, 16, 128, 1 << 17)
        hist = np.histogram(gaps, bins=edges)[0]
        print("  offset mismatch within K4's pairs: " + ", ".join(
            f"[{a}, {b}) {int(n)}" for a, b, n in zip(edges, edges[1:],
                                                       hist))
              + f"; cells swept {swept_all} against the bound's {cells} "
              f"({swept_all / cells:.3f}x)")

    # K5's candidate plans (rows a lane, warps) at the per-segment shape
    # (m16 = 1,584: each with a warp a strip, then 4 strips on 2 warps and
    # on 1) and at NEAT1 length (m16 = 22,768)
    K5_PLANS = ((4, 13), (5, 10), (6, 9), (7, 8), (8, 7), (10, 5), (13, 4),
                (13, 2), (13, 1))
    K5_PLANS_NEAT1 = ((16, 16), (16, 8), (8, 16))

    def k5_times(self) -> None:
        """K5 at the per-segment shape (both alphabets; the ssw pass is the
        reported one) on the library's plan and on the candidate plans,
        its step loop's SASS, registers and resident warps; at the
        packed-batch shape; on the per-segment rows at NEAT1 length."""
        torch = self.torch
        from fasim_tpu_torch.kernels.engine import TorchScanEngine
        from fasim_tpu_torch.kernels.scan_codes import (
            kernel_plan, scan_codes_colmax, scan_codes_colmax_ref)

        rna = self.k5_rna
        eng = TorchScanEngine(rna, device=self.dev)
        shapes = {}
        for which in ("thresh", "ssw"):
            codes = torch.from_numpy(self.k5_codes(which, self.k5_seg,
                                                   5000)).to(self.dev)
            args = (codes, eng._dev[f"qprops_{which}"],
                    eng._dev[f"ctab_{which}"], eng.m16, which)
            shapes[which] = self.cuda_ms(lambda: scan_codes_colmax(*args), 5)
        plain = self.cuda_ms(lambda: scan_codes_colmax_ref(
            *args[:2], eng.m16, "ssw"), 1, warm=False)
        rows, N = codes.shape[1], codes.shape[2]
        plan = kernel_plan(rows, eng.m16)
        self.ms["scan_codes_colmax"] = shapes["ssw"]
        self.plain_ms["scan_codes_colmax"] = plain
        cells = rows * N * eng.m16
        self.work["scan_codes_colmax"] = (
            scan_ops_per_cell(eng.m16, N) * cells,
            rows * N + 4 * rows * N + 16 * eng.m16)
        bound_ms = self.bound(*self.work["scan_codes_colmax"])[0]
        print(f"  K5 scan_codes_colmax, per-segment shape S=1 T={rows} "
              f"N={N} m={len(rna)}, plan {plan} (rows a lane, warps): "
              f"kernel ssw {shapes['ssw']:.3f} ms, thresh "
              f"{shapes['thresh']:.3f} ms, plain (ssw) {plain:.3f} ms; "
              f"bound {bound_ms:.4f} ms, {bound_ms / shapes['ssw']:.2%} of "
              f"it; int32-form floor (7 a cell) "
              f"{self.bound(7 * cells, 0)[0]:.4f} ms")
        self.k5_rates(plan, N, rows, shapes["ssw"])
        times = {p: self.cuda_ms(lambda p=p: scan_codes_colmax(
            *args, plan=p), 5) for p in self.K5_PLANS}
        print("  K5 per-segment ssw pass by plan (rows a lane, warps): "
              + ", ".join(f"{p} {ms:.3f} ms" for p, ms in times.items()))
        self.k5_step_probe(codes)
        packed = torch.from_numpy(self.k5_codes(
            "ssw", [self.dna(5120) for _ in range(64 * rows)], 5120).reshape(
                64, rows, 5120)).to(self.dev)
        pargs = (packed, eng._dev["qprops_ssw"], eng._dev["ctab_ssw"],
                 eng.m16, "ssw")
        ms = self.cuda_ms(lambda: scan_codes_colmax(*pargs), 3)
        pplan = kernel_plan(64 * rows, eng.m16)
        cells = packed.numel() * eng.m16
        bound_ms = self.bound(
            scan_ops_per_cell(eng.m16, 5120) * cells, 0)[0]
        print(f"  K5 scan_codes_colmax, packed batch S=64 T={rows} N=5120 "
              f"m={len(rna)}, ssw, plan {pplan}: kernel {ms:.3f} ms "
              f"({cells / ms / 1e6:.1f} G cell-updates/s; bound "
              f"{bound_ms:.3f} ms; int32-form floor "
              f"{self.bound(7 * cells, 0)[0]:.3f} ms)")
        self.k5_rates(pplan, 5120, 64 * rows, ms)
        self.k5_neat1(codes)

    def k5_step_probe(self, codes) -> None:
        """The time of one step of K5's pipelined sweep against its rows a
        lane R: the per-segment rows (48 x N) at m16 = 64 R, two strips on
        two warps (one a scheduler), so N + 94 steps; and the least-squares
        line through the cycles a step at the max SM clock."""
        np = self.np
        from fasim_tpu_torch.kernels.engine import TorchScanEngine
        from fasim_tpu_torch.kernels.scan_codes import scan_codes_colmax

        N = codes.shape[-1]
        rows, cycles = (2, 4, 8, 13, 16), []
        for per_lane in rows:
            eng = TorchScanEngine(self.dna(64 * per_lane), device=self.dev)
            args = (codes, eng._dev["qprops_ssw"], eng._dev["ctab_ssw"],
                    eng.m16, "ssw")
            ms = self.cuda_ms(lambda: scan_codes_colmax(
                *args, plan=(per_lane, 2)), 5)
            cycles.append(ms * 1e-3 * self.sm_hz / (N + 94))
        slope, icept = np.polyfit(rows, cycles, 1)
        print("  K5 step probe (2 strips on 2 warps, cycles a step at "
              f"{self.sm_hz / 1e6:.0f} MHz): " + ", ".join(
                  f"{r} rows {c:.0f}" for r, c in zip(rows, cycles))
              + f"; fit {icept:.0f} + {slope:.1f} a row a lane")

    def k5_rates(self, plan, N: int, rows: int, ms: float) -> None:
        """The SASS count of the step loop of the K5 instantiation a plan
        launches (sass_loop), its ptxas registers, its resident warps an SM
        (the occupancy calculator) and the waves of its `rows` blocks."""
        from fasim_tpu_torch.kernels.scan_codes import blocks_per_sm

        per_lane, warps = plan
        name = f"scan_codes_kernelILi{per_lane}ELb{int(warps > 1)}E"
        sass = sass_loop(name)
        regs = [r for e, r in ptxas_registers().items() if name in e]
        sms = self.torch.cuda.get_device_properties(0).multi_processor_count
        blocks = blocks_per_sm(plan, N)
        print(f"  K5 {name}: step loop {sass['loop']} instructions, "
              f"{sass['loop'] / per_lane:.2f} a cell, "
              f"{sass['loop_integer']} integer; column block "
              f"{sass['block']} ({sass['cell_ops'] / per_lane:.2f} a cell "
              f"the cells' own); {regs[0] if regs else '?'} registers; "
              f"{blocks} blocks of {warps} warps = {blocks * warps} resident "
              f"warps an SM; {rows} blocks = {rows / (blocks * sms):.3f} "
              f"waves on {sms} SMs; {ms:.3f} ms")

    def k5_neat1(self, codes) -> None:
        """K5 on the per-segment rows (48 x 5,000) at NEAT1 length (m =
        22,767), ssw pass, kernel only, on the library's plan and the
        candidates."""
        from fasim_tpu_torch.kernels.engine import TorchScanEngine
        from fasim_tpu_torch.kernels.scan_codes import (kernel_plan,
                                                        scan_codes_colmax)

        eng = TorchScanEngine(self.dna(NEAT1_M), device=self.dev)
        args = (codes, eng._dev["qprops_ssw"], eng._dev["ctab_ssw"],
                eng.m16, "ssw")
        rows, N = codes.shape[1], codes.shape[2]
        plan = kernel_plan(rows, eng.m16)
        ms = self.cuda_ms(lambda: scan_codes_colmax(*args), 2)
        cells = rows * N * eng.m16
        ops = scan_ops_per_cell(eng.m16, N)
        bound_ms = self.bound(ops * cells, 0)[0]
        print(f"  K5 scan_codes_colmax at NEAT1 length, per-segment rows "
              f"S=1 T={rows} N={N} m={NEAT1_M} (m16 {eng.m16}), ssw, plan "
              f"{plan}: kernel {ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({ops} a cell), int32-form floor (7 a cell) "
              f"{self.bound(7 * cells, 0)[0]:.3f} ms")
        self.k5_rates(plan, N, rows, ms)
        times = {p: self.cuda_ms(lambda p=p: scan_codes_colmax(
            *args, plan=p), 2) for p in self.K5_PLANS_NEAT1}
        print("  K5 at NEAT1 length by plan: " + ", ".join(
            f"{p} {t:.3f} ms" for p, t in times.items()))

    def k8_times(self) -> None:
        """K8 at h19_F's group shape and at NEAT1 length against its bound,
        its plain version (timed in phase 3) and every instantiation, and
        the fit of its time (a lag a strip and a cost a step, a + b rows,
        over both shapes, the model of sim_dev.kernel_rows); its registers
        and shared memory a block (held against sim_dev.smem_bytes); its
        launches a run (phase 4); and the split of sim_forward_cells on
        h19_F's group.  phase_times prints every kernel's registers."""
        np = self.np
        from fasim_tpu_torch.kernels import _build
        from fasim_tpu_torch.kernels.sim_dev import (KERNEL_ROWS,
                                                     chain_steps,
                                                     kernel_rows, sim_forward,
                                                     smem_bytes)

        points = []  # (m, N, rows, ms)
        for label, (q, refs, m), plain in (
                ("h19_F group", self.k8_h19, self.k8_plain_h19),
                ("NEAT1 length", self.k8_neat1, self.k8_plain_neat1)):
            T, N = refs.shape
            ms = self.cuda_ms(lambda: sim_forward(q, refs, m), 5)
            cells = T * m * N
            work = (SIM_OPS_PER_CELL * cells,
                    8 * cells + 4 * q.numel() + 4 * refs.numel())
            bound_ms, by = self.bound(*work)
            if label == "h19_F group":
                self.ms["sim_forward"] = ms
                self.plain_ms["sim_forward"] = plain
                self.work["sim_forward"] = work
            times = {r: self.cuda_ms(
                lambda r=r: sim_forward(q, refs, m, rows=r), 3)
                for r in KERNEL_ROWS}
            points += [(m, N, r, t) for r, t in times.items()]
            print(f"  K8 sim_forward, {label} T={T} m={m} N={N}: kernel "
                  f"{ms:.3f} ms at {kernel_rows(m, N, T)} rows a lane "
                  f"({cells / ms / 1e6:.1f} G cells/s), plain {plain:.3f} "
                  f"ms; bound {bound_ms:.4f} ms ({by}), {bound_ms / ms:.2%}"
                  " of it; library: none; by rows a lane: "
                  + ", ".join(f"{r} {t:.3f} ms" for r, t in times.items()))
        # the model of kernel_rows: chain_steps(m, N, rows, lag) x (a + b
        # rows) ns, lag by search and (a, b) by least squares
        best = None
        for lag in range(32, 97):
            x = np.array([[chain_steps(m, n, r, lag),
                           chain_steps(m, n, r, lag) * r]
                          for m, n, r, _ in points], float)
            y = np.array([t * 1e6 for *_, t in points])
            ab = np.linalg.lstsq(x, y, rcond=None)[0]
            err = float(np.max(np.abs(x @ ab - y) / y))
            if best is None or err < best[0]:
                best = (err, lag, ab)
        err, lag, (a, b) = best
        print(f"  K8 fitted cost, by rows a lane: a strip lags {lag} steps,"
              f" a step costs {a:.1f} + {b:.1f} x rows ns (" + ", ".join(
                  f"{r} rows {a + b * r:.1f} ns" for r in KERNEL_ROWS)
              + f"); largest error {err:.1%} over both shapes")
        regs = {short_name(k): v for k, v in ptxas_registers().items()}
        lib = _build.lib()
        for r in KERNEL_ROWS:
            require(lib.fasim_sim_forward_smem(r) == smem_bytes(r),
                    f"K8 at {r} rows a lane: the library's block takes "
                    f"{lib.fasim_sim_forward_smem(r)} B of shared memory, "
                    f"sim_dev.smem_bytes {smem_bytes(r)}")
        print("  K8 registers and shared memory a block (one warp): "
              + ", ".join(f"{r} rows "
                          f"{regs.get(f'sim_forward_kernelILi{r}E', '?')} "
                          f"registers, {smem_bytes(r)} B"
                          for r in KERNEL_ROWS)
              + " (sim_dev.smem_bytes agrees with the library)")
        for run, counts in self.counts.items():
            if counts["sim_forward"]:
                print(f"  K8 launches, {run}: {counts['sim_forward']}")
        self.k8_cells_split()
        self.k8_host_split()

    CELLS_REPS = 5

    def k8_cells_split(self) -> None:
        """sim_forward_cells on h19_F's group, piece by piece (its own
        `times`: CUDA events around each piece's device work and the host
        clock up to its synchronize), with no replay running; its cells
        must equal those of an untimed call."""
        np = self.np
        from fasim_tpu_torch.kernels.sim_dev import (CELLS_PIECES,
                                                     sim_forward_cells)

        h19, refs_u8, mins = self.k8_group
        want = sim_forward_cells(h19, refs_u8, mins, self.dev)
        times, wall = {}, 0.0
        for _ in range(self.CELLS_REPS):
            t0 = time.perf_counter()
            got = sim_forward_cells(h19, refs_u8, mins, self.dev, times)
            wall += (time.perf_counter() - t0) * 1e3
            require(len(got) == len(want) and all(
                np.array_equal(g, w) for g, w in zip(got, want)),
                "sim_forward_cells differs when timed piece by piece")
        k = self.CELLS_REPS
        print(f"  sim_forward_cells on the h19_F group, "
              f"{sum(len(w) for w in want)} cells, piece by piece (mean of "
              f"{k}, device ms by CUDA events / host ms to the piece's "
              "synchronize): " + "; ".join(
                  f"{name} {sum(d for d, _ in times[name]) / k:.3f} / "
                  f"{sum(h for _, h in times[name]) / k:.3f}"
                  for name in CELLS_PIECES)
              + f"; all {wall / k:.3f} ms on the host clock")

    def k8_host_split(self) -> None:
        """What K8 takes off the host: one h19_F pair's exact SIM with its
        own forward scan (native.sim_scan) against the replay of K8's
        qualifying cells (native.sim_scan_replay), host clock, one
        thread; the two must give the same rows."""
        from fasim_tpu_torch import native
        from fasim_tpu_torch.config import Params

        p = Params()
        rna, seq2, src, min_score, scan, cells = self.k8_pair
        args = (rna.tobytes(), seq2.tobytes(), src.tobytes(), 0, min_score,
                scan["strand"], scan["para"], p.nt_min, p.nt_max,
                p.penalty_t, p.penalty_c)
        t0 = time.perf_counter()
        host = native.sim_scan(*args)
        t1 = time.perf_counter()
        replay = native.sim_scan_replay(*args, cells)
        t2 = time.perf_counter()
        require(replay == host and host, "h19_F pair 0: the replay of K8's "
                "cells differs from the host SIM")
        print(f"  h19_F pair 0 on the host (one thread): sim_scan "
              f"{t1 - t0:.3f} s, sim_scan_replay of K8's {len(cells)} cells "
              f"{t2 - t1:.3f} s, {len(host)} rows, equal")

    # -- phase 8 ---------------------------------------------------------

    def phase_trace(self) -> None:
        """The default MEG3-full run through the CLI (MEG3_FULL, checked as
        phase 4 checks its runs; the report's counts of K1, K3 and K4),
        under torch.profiler: the device time of each kernel and copy
        (CUDA activity events, summed by name) and their sum against the
        run's wall."""
        import collections

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        note = " under torch.profiler"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self.golden_case(*self.MEG3_FULL, note=note)
        [wall] = [w for run, w in self.walls.items() if run.endswith(note)]
        busy_us = collections.Counter()
        count = collections.Counter()
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                busy_us[evt.name] += evt.time_range.elapsed_us()
                count[evt.name] += 1
        require(len(busy_us) > 0, "meg3_full under torch.profiler: the "
                "profiler recorded no device events")
        busy = sum(busy_us.values()) / 1e6
        print(f"  meg3_full (cli) under torch.profiler: device busy "
              f"{busy:.3f} s summed over kernels and copies ({busy / wall:.1%}"
              f" of the wall {wall:.3f} s)")
        for name, us in busy_us.most_common(16):
            print(f"    {us / 1e3:.3f} ms in {count[name]} x {name[:100]}")

    # -- phase 9 ---------------------------------------------------------

    @staticmethod
    @contextlib.contextmanager
    def recorded_dispatches():
        """In the block, every TorchScanEngine.window_pass_specs call: (the
        engine, segs, lengths, spec, rev, the ends it returned), each
        argument copied."""
        import numpy as np
        import torch

        from fasim_tpu_torch.kernels.engine import TorchScanEngine

        calls = []
        real = TorchScanEngine.window_pass_specs

        def copy(a):
            return a.clone() if torch.is_tensor(a) else np.array(a)

        def recorded(eng, segs, lengths, spec, rev):
            ends = real(eng, segs, lengths, spec, rev)
            calls.append((eng, copy(segs), copy(lengths),
                          {k: np.array(v) for k, v in spec.items()}, rev,
                          ends.copy()))
            return ends

        TorchScanEngine.window_pass_specs = recorded
        try:
            yield calls
        finally:
            TorchScanEngine.window_pass_specs = real

    def held_rows(self, part, m: int):
        """The rows of one width class of a dispatch held against the plain
        version: every row whose offset or mreal passes 65,536, and a
        seeded sample of LONG_HELD of the others (all of them if fewer)."""
        np = self.np
        offs = part["offs"].cpu().numpy()
        mreals = part["mreals"].cpu().numpy()
        past = (offs > 1 << 16) | (mreals > 1 << 16)
        rest = np.flatnonzero(~past)
        if len(rest) > LONG_HELD:
            rest = self.rng.choice(rest, LONG_HELD, replace=False)
        return np.sort(np.concatenate([np.flatnonzero(past), rest]))

    def long_dispatch_checks(self, calls, kernel: str) -> int:
        """Every recorded dispatch's ends (the run's own, from `kernel`)
        against the plain version on its held rows, per width class, in
        chunks of LONG_HELD rows: K4's window_pass_ref, also for K6's long
        form (v1's ends and K4's cannot differ; K6's plain chain, held
        against it at lengths past 65,536 in phase 3 and on the CPU, steps
        all 91,068 query rows a call).  Returns the rows held."""
        torch = self.torch
        from fasim_tpu_torch.kernels.window import window_pass_ref

        held = 0
        for eng, segs, lens, spec, rev, ends in calls:
            qp = eng._dev["qwin_rev" if rev else "qwin_fwd"]
            for W, codes, part in self.spec_codes(eng, segs, lens, spec, rev):
                rows = self.held_rows(part, eng.m)
                got = torch.from_numpy(ends[part["sel"][rows]]).to(self.dev)
                for c in range(0, len(rows), LONG_HELD):
                    r = torch.from_numpy(rows[c:c + LONG_HELD]).to(self.dev)
                    want = window_pass_ref(codes[r], qp, part["offs"][r],
                                           part["terms"][r],
                                           part["rlens"][r],
                                           part["mreals"][r], eng.m)
                    self.compare(kernel, got[c:c + LONG_HELD], want,
                                 f"91 kb {'rev' if rev else 'fwd'} dispatch "
                                 f"W={W}")
                held += len(rows)
                print(f"    {'reverse' if rev else 'forward'} dispatch, "
                      f"W={W}: {len(rows)} of {len(part['sel'])} rows held, "
                      f"equal")
        return held

    def phase_long(self) -> None:
        """The long query (long_query(): 91,068 nt) x oracle/testDNA.fa (one
        segment, one batch) through the CLI (batched driver, fastSIM, no
        -F), default (K1, then every window pass on K4's long form
        window_general_long: the forward specs too, past K3_MAX_M) and under
        FASIM_WIN_V1=1 (K6's long form window_v1_long): each run launches
        its long form in its window passes and no other window kernel,
        every window dispatch is recorded and held against the plain
        version on its held rows (`held_rows`), both runs write the same
        files and stdout, with TFOsorted rows; K1 (and K7) at that length
        on testDNA's segment against the plain version; no wrapper, entry
        point or kernel of the retired int32 long-query kernels is left.
        Each run's wall is kept; its long form's launches are the kernels
        line's."""
        from fasim_tpu_torch.config import Params
        from fasim_tpu_torch.io import fasta
        from fasim_tpu_torch.kernels import _build, window, window_v1

        # the int32 long-query kernels are gone: no wrapper, no entry point,
        # no kernel in the library
        gone = [name for name in ("window_general32", "window_keys")
                if hasattr(window, name) or hasattr(window_v1, name)]
        gone += [name for name in ("fasim_window_general",
                                   "fasim_window_keys")
                 if hasattr(_build.lib(), name)]
        gone += [name for name in ptxas_registers()
                 if "window_ends_kernel" in name
                 or "window_keys_kernel" in name]
        require(not gone, f"retired long-query kernels still built: {gone}")
        rna = long_query()
        p = Params()
        [rec] = fasta.read_dna(os.path.join(ORACLE, "testDNA.fa"))
        segs, _ = fasta.cut_sequence(rec.seq, p.cut_length, p.overlap_length)
        self.k1_case(f"{len(rna)}-nt query x testDNA", rna, segs, 5120,
                     k7_plain=False)
        window_kernels = ("window_fwd", "window_general",
                          "window_general_long", "window_v1",
                          "window_v1_long")
        outs = []
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "NEAT1x4.fa"), "w") as f:
                f.write(">NEAT1x4\n" + rna.tobytes().decode() + "\n")
            shutil.copy(os.path.join(ORACLE, "testDNA.fa"), tmp)
            for n, (env, kernel) in enumerate((
                    ({}, "window_general_long"),
                    ({"FASIM_WIN_V1": "1"}, "window_v1_long"))):
                run = (f"{len(rna)}-nt query x testDNA (cli"
                       + "".join(f", {k}={v}" for k, v in env.items()) + ")")
                with kept_environment(), switches(**env), \
                        self.driver_calls() as drivers, \
                        self.recorded_dispatches() as calls:
                    self.reset_counts()
                    wall, stdout = self.run_cli(
                        tmp, run, "testDNA.fa", "NEAT1x4.fa", [],
                        out=f"out{n}")
                    counts = self.read_counts()
                require(drivers == {"scan_file_batched": 1},
                        f"{run}: drivers run {drivers}")
                print(f"  {run}: wall {wall:.3f} s, {len(calls)} window "
                      f"dispatches ({sum(len(c[3]['rlens']) for c in calls)}"
                      f" rows), launches {counts}")
                require(counts["scan_colmax"] > 0 and counts[kernel] > 0,
                        f"{run}: scan_colmax or {kernel} never launched")
                for k in (*window_kernels, "sim_forward"):
                    require(k == kernel or counts[k] == 0,
                            f"{run}: {k} launched {counts[k]} times")
                t0 = time.perf_counter()
                held = self.long_dispatch_checks(calls, kernel)
                print(f"  {run}: {held} window rows held against the plain "
                      f"version, equal ({time.perf_counter() - t0:.1f} s)")
                files = {}
                for name in sorted(os.listdir(os.path.join(tmp, f"out{n}"))):
                    with open(os.path.join(tmp, f"out{n}", name), "rb") as f:
                        files[name] = f.read()
                outs.append((files, stdout_lines(stdout)))
                self.walls[run] = wall
                self.counts[run] = counts
                self.launches[kernel] = counts[kernel]
                if not env:  # long_times times its dispatches
                    self.long_calls = calls
        require(outs[0] == outs[1], "the 91 kb runs' outputs differ between "
                "the default and FASIM_WIN_V1=1")
        [sorted_name] = [k for k in outs[0][0] if k.endswith("TFOsorted")]
        rows = outs[0][0][sorted_name].count(b"\n") - 1
        require(rows > 0, f"{sorted_name}: no TFOsorted rows")
        print(f"  both runs write the same {len(outs[0][0])} files and "
              f"stdout; {sorted_name}: {rows} rows")
        self.long_times()

    def long_times(self) -> None:
        """K4's and K6's long forms (window_general_long, window_v1_long) and
        the plain version (window_pass_ref, in chunks of LONG_HELD rows) on
        the largest forward and on the largest reverse window dispatch of
        the default 91 kb run, each with its bound (WINDOW_OPS_PER_CELL a
        needed cell) and the kernel's share of it; the kernels line gives
        the sums over both dispatches.  K6's plain time is K4's plain
        version's: its own chain steps every query row a call."""
        np = self.np
        torch = self.torch
        from fasim_tpu_torch.kernels.window import (window_general_long,
                                                    window_pass_ref)
        from fasim_tpu_torch.kernels.window_v1 import window_v1_long

        acc = {k: [0.0, 0.0, 0.0, 0] for k in ("window_general_long",
                                               "window_v1_long")}
        for rev in (False, True):
            eng, segs, lens, spec, _, _ = max(
                (c for c in self.long_calls if c[4] == rev),
                key=lambda c: len(c[3]["rlens"]))
            parts = self.spec_codes(eng, segs, lens, spec, rev)
            m = eng.m
            qp = eng._dev["qwin_rev" if rev else "qwin_fwd"]
            tab = eng._dev["wtab_rev" if rev else "wtab_fwd"]
            qc = eng._qcodes(rev)

            def run(how, parts=parts, qp=qp, tab=tab, qc=qc, m=m):
                for _, codes, part in parts:
                    args = (part["offs"], part["terms"], part["rlens"],
                            part["mreals"], m)
                    if how == "window_general_long":
                        window_general_long(codes, qp, *args, tab)
                    elif how == "window_v1_long":
                        window_v1_long(codes, qc, *args, tab)
                    else:
                        for c in range(0, codes.shape[0], LONG_HELD):
                            window_pass_ref(codes[c:c + LONG_HELD], qp,
                                            *(a[c:c + LONG_HELD]
                                              for a in args[:4]), m)

            plain = self.cuda_ms(lambda: run("plain"), 1, warm=False)
            rl = spec["rlens"].astype(np.int64)
            top = np.maximum(spec["mreals"], m).astype(np.int64)
            cells = int((rl * (top - np.maximum(spec["offs"], 0))).sum())
            rows = len(rl)
            nbytes = sum(int(c.numel()) for _, c, _ in parts) + rows * 28 \
                + 8 * int(tab.shape[0])
            bound_ms = self.bound(WINDOW_OPS_PER_CELL * cells, nbytes)[0]
            widths = {W: int(c.shape[0]) for W, c, _ in parts}
            line = []
            for kernel in acc:
                ms = self.cuda_ms(lambda: run(kernel), 5)
                for i, v in enumerate((ms, plain, WINDOW_OPS_PER_CELL * cells,
                                       nbytes)):
                    acc[kernel][i] += v
                line.append(f"{kernel} {ms:.3f} ms ({bound_ms / ms:.1%} of "
                            "the bound)")
            print(f"  91 kb query, {'reverse' if rev else 'forward'} "
                  f"dispatch of {rows} rows (rows per width {widths}), "
                  f"m={m}, {cells} cells: bound {bound_ms:.3f} ms; "
                  + "; ".join(line) + f"; plain {plain:.3f} ms")
            # the same dispatch with its rows repeated LONG_TILE times:
            # enough warps to fill the card, where the dispatch alone
            # leaves most of it idle
            tiled = [(W, codes.repeat(LONG_TILE, 1),
                      {k: v.repeat(LONG_TILE) for k, v in part.items()
                       if k != "sel"}) for W, codes, part in parts]
            line = []
            for kernel in acc:
                ms = self.cuda_ms(lambda: run(kernel, tiled), 3)
                line.append(f"{kernel} {ms:.3f} ms "
                            f"({LONG_TILE * bound_ms / ms:.1%} of the bound)")
            print(f"    its rows {LONG_TILE} times over: " + "; ".join(line))
            if rev:
                self.k4_sweep(spec, parts, qp, tab, m, cells)
            torch.cuda.empty_cache()
        for kernel, (ms, plain, ops, nbytes) in acc.items():
            self.ms[kernel], self.plain_ms[kernel] = ms, plain
            self.work[kernel] = (ops, nbytes)

    def bound(self, ops: float, nbytes: float):
        """(least ms the card could take, the term that sets it)."""
        t_ops = ops / self.int32_ops * 1e3
        t_bytes = nbytes / MEM_BPS * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes \
            else (t_bytes, "bytes")

    def report(self) -> dict:
        out = []
        for name, (src, replaces) in self.KERNELS.items():
            bound_ms, bound_by = self.bound(*self.work[name])
            # no single PyTorch call computes SW column maxima or window
            # ends, so there is no library time to give
            out.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": self.launches.get(name, 0),
                        "max_abs_err": self.err[name],
                        "ms": self.ms.get(name),
                        "plain_ms": self.plain_ms.get(name),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
        return {"kernels": out}


PHASES = ("device", "build", "kernels", "e2e", "multi", "genome", "times",
          "trace", "long")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "fasim_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        smoke = Smoke()
        for name in PHASES:
            t0 = time.perf_counter()
            getattr(smoke, f"phase_{name}")()
            print(f"phase {name}: ok, {time.perf_counter() - t0:.1f} s",
                  flush=True)
    except Exception:  # noqa: BLE001 — any failure fails the smoke run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    for run, wall in smoke.walls.items():
        print(f"wall {run}: {wall:.3f} s on {smoke.smi}")
    for line in smoke.genome:
        print(line)
    print(smoke.smi)
    print(json.dumps(smoke.report()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
