"""Batched and streaming scan of the port.

Counterpart of fasim_tpu/scan/batched.py (iter_scan_work, scan_work,
scan_records, scan_file_batched, RecordMeta, scan_file_stream) for a
`TorchScanEngine`, with copies of that module's host helpers (`_Work`,
`enumerate_work`, `_ScanMeta`, the `-F` branch of `_host_segment_stage`,
`_sim_pool`, `corenum_buckets`, `filter_fix_record`,
`finalize_record_into`, `finalize_records`, the glibc heap settings
`_LIBC` and `malloc_trim`).  The fastSIM candidate stage is the port's
scan/candidates.py, so the output is byte-identical to the JAX
package's.  Differences from fasim_tpu.scan.batched:

  * prewarm (scan/prewarm.py) builds and loads the kernel and native
    libraries and makes the first launches of the engines' kernels, as
    the JAX package compiles its shapes, but its failures are raised at
    the engine's first dispatch, not swallowed;
  * `max_inflight` 0 or less means 2 batches an engine, not "dispatch
    everything up front";
  * the packed candidates come back with one `.cpu()` of the pos / val
    slices after the counts, instead of `jax.device_get`;
  * `-F` (exact SIM) fetches only the thresholds; under FASIM_SIM_DEVICE=1
    the forward scan runs on the engine's device (kernels/sim_dev.py, K8
    on a CUDA engine, its plain version on a CPU one), the qualifying
    cells are picked out there, and each group's pairs replay on the SIM
    pool in scan order (fasim_tpu replays them on its finalize thread);
  * each engine runs on its device's current CUDA stream;
  * when the watchdog fires, the thread pools are shut down without
    waiting for the wedged thread, and its message names no checkpoint
    (only dist/runner.py keeps one);
  * no opt-in mmap threshold pin (FASIM_MMAP_PIN): the JAX package
    measured it at peak RSS 3142 -> 2995 MB for +54% wall, and nothing
    here turns it on;
  * `scan_file_stream` closes its store (and removes its spill file) when
    the scan raises.

`engine` is one TorchScanEngine or a list of them, one a device (the
JAX package's per-device engines): batch k goes to engine k mod the
count.  Segments are independent, so no collective is needed.  Batches
are dispatched up to `max_inflight` an engine ahead; one stage thread
per in-flight batch waits for its device results on its batch's engine
and runs the candidate stage, and the host finalize runs on a thread
pool.  Results are yielded in input order, so the output does not
depend on the engine count, the window or the thread counts.
`scan_file_batched` reads every record first and returns a Triplex
list; `scan_file_stream` reads one record at a time and returns a
columnar `post.store.TriplexStore`, for genome-scale inputs.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeout

import numpy as np
import torch

from .. import rules
from ..config import BYTE_SAT, Params
from ..io import fasta
from ..kernels.sim_dev import sim_device_ok, sim_forward_cells
from ..profiling import STAGES
from . import prewarm
from .candidates import candidate_stage_batch
from .pipeline import Triplex, _sim

# glibc heap knobs for the long streamed runs: freed short-lived host
# mirrors (colmax rows, packed candidates) otherwise keep RSS growing.
# The arena cap must be applied BEFORE any worker thread exists — arenas
# created earlier escape it — so it runs at module import, not inside
# the driver.
try:
    import ctypes

    _LIBC = ctypes.CDLL("libc.so.6")
    _LIBC.mallopt(-8, 4)  # M_ARENA_MAX
except OSError:
    _LIBC = None


_SIM_POOL = None


def _sim_pool() -> ThreadPoolExecutor:
    """Shared executor for the exact-SIM (-F) pair fan-out; the native
    scan releases the GIL, so pairs run truly concurrently.  Module
    level (not per segment) so total concurrency stays bounded at the
    core count even when several segments are in flight."""
    global _SIM_POOL
    if _SIM_POOL is None:
        _SIM_POOL = ThreadPoolExecutor(
            max_workers=max(1, os.cpu_count() or 1),
            thread_name_prefix="fasim-sim")
    return _SIM_POOL


@dataclasses.dataclass
class _Work:
    """One (record, segment) pair queued for the device scan."""

    record_idx: int
    start: int  # dnaStartPos of the segment within the record
    segment: np.ndarray
    gidx: int = -1  # global work index (distributed sharding/merge key)


def enumerate_work(p: Params, records) -> tuple[list[_Work], list[dict]]:
    scans = rules.scan_list(p.rule, p.strand)
    work: list[_Work] = []
    for ri, rec in enumerate(records):
        segs, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                          p.overlap_length)
        for seg, start in zip(segs, starts):
            if fasta.same_seq(seg):
                continue
            work.append(_Work(ri, start, seg))
    return work, scans


_SRC_KINDS = ("fwd", "revcomp", "comp", "rev")


class _ScanMeta:
    """Per-run scan metadata arrays for the candidate stage."""

    def __init__(self, scans: list[dict]):
        t = len(scans)
        self.scans = scans
        self.luts = np.empty((t, 256), np.uint8)
        self.xform_rev = np.empty(t, np.int8)
        self.src_sel = np.empty(t, np.int8)
        self.strands = np.empty(t, np.int32)
        self.paras = np.empty(t, np.int32)
        for k, s in enumerate(scans):
            self.luts[k] = rules.transfer_lut(s["strand"], s["para"],
                                              s["rule"])
            self.xform_rev[k] = s["xform"] == "tr"
            self.src_sel[k] = _SRC_KINDS.index(s["src"])
            self.strands[k] = s["strand"]
            self.paras[k] = s["para"]
        self.ssw_enc_u8 = rules.SSW_ENC.astype(np.uint8)
        self.mat = np.ascontiguousarray(rules.SSW_MAT, np.int32)


def _host_segment_stage(p: Params, rna: np.ndarray, meta: _ScanMeta,
                        w: _Work, gm_row: np.ndarray,
                        device: torch.device) -> list[Triplex]:
    """Exact SIM (-F) for one segment, all transforms, in the reference's
    transform order; only the thresholds gm_row are read.  Runs on a
    worker thread, inside the span `host_candidate_busy`.  Under
    FASIM_SIM_DEVICE=1 the forward scans run on `device`, the engine's
    (fasim_tpu/scan/batched.py:160-202).
    (fasim_tpu's `_host_segment_stage` also serves the fastSIM path of
    engines without window passes; every engine of the port has them, so
    its fastSIM path is candidates.py.)"""
    scans = meta.scans
    pairs = [rules.make_scan_strings(w.segment, s) for s in scans]
    mins = [int(int(gm_row[k]) * 0.8) for k in range(len(scans))]

    # the 48 (segment, transform) pairs are fully independent (each owns
    # its node list / used-cell state, sim.h:410-1143); run them across
    # cores and concatenate in scan order — the reference's iteration
    # order, so output is bit-identical.  The reference runs this loop on
    # one core (SURVEY §2.b).
    def one(k, cells=None):
        scan = scans[k]
        part: list[Triplex] = []
        _sim(rna, pairs[k][0], pairs[k][1], w.start, mins[k],
             scan["strand"], scan["para"], scan["rule"], p, part, cells)
        return part

    m, n = len(rna), len(w.segment)
    if (os.environ.get("FASIM_SIM_DEVICE", "0") != "1"
            or not sim_device_ok(m, n)):
        found: list[Triplex] = []
        for part in _sim_pool().map(one, range(len(scans))):
            found.extend(part)
        return found
    return _device_sim(rna, pairs, mins, device, one)


def _device_sim(rna: np.ndarray, pairs: list, mins: list[int], device,
                one) -> list[Triplex]:
    """The forward scans of one segment's pairs on `device`, in groups of
    up to 8 whose (cs, ct) matrices stay near 256 MB; each pair's cells
    replay through `one(k, cells)` on the SIM pool while the next groups
    scan.  The cells of at most two pairs a pool thread (and two groups)
    wait on the host."""
    m, n = len(rna), len(pairs[0][0])
    mp = (m + 7) // 8 * 8
    tg = max(1, min(8, (256 << 20) // max(1, n * mp * 8)))
    keep = max(2 * tg, 2 * (os.cpu_count() or 1))
    found: list[Triplex] = []
    pending: collections.deque = collections.deque()

    def drain(keep: int) -> None:
        while len(pending) > keep:
            found.extend(pending.popleft().result())

    for lo in range(0, len(pairs), tg):
        grp = range(lo, min(lo + tg, len(pairs)))
        cells = sim_forward_cells(rna, [pairs[k][0] for k in grp],
                                  [mins[k] for k in grp], device)
        pending.extend(_sim_pool().submit(one, k, c)
                       for k, c in zip(grp, cells))
        drain(keep)
    drain(0)
    return found


def corenum_buckets(n: int) -> list[list[Triplex]]:
    """Bucket list emulating the reference's `-C corenum` round-robin:
    record i's triplexes append to bucket i % corenum, and the final
    list is the buckets concatenated in bucket order (Fasim-LongTarget.
    cpp:129-163 — no threads are ever spawned, but the permutation
    changes TFOsorted row order within sort-tie classes because the
    class sort is non-stable on pre-sort order, :813,:847-850)."""
    return [[] for _ in range(max(1, n))]


def filter_fix_record(p: Params, rec, lst: list[Triplex]) -> list[Triplex]:
    """Final per-record filter (Fasim-LongTarget.cpp:589-597) +
    genome-coordinate fixup (main:141-149) for one record's hits; rec
    needs only .chro_tag / .start_genome."""
    f32 = np.float32
    lst = [t for t in lst
           if (t.score >= f32(p.score_min)
               and t.identity >= f32(p.min_identity)
               and t.tri_score >= f32(p.min_stability)
               and t.nt >= p.c_length)]
    for t in lst:
        if t.genomestart == 0:
            t.chr = rec.chro_tag
            t.genomestart = t.starj + rec.start_genome - 1
            t.genomeend = t.endj + rec.start_genome - 1
    return lst


def finalize_record_into(buckets: list[list[Triplex]], p: Params, ri: int,
                         rec, lst: list[Triplex]) -> None:
    """filter_fix_record + `-C` bucket append, shared by every driver
    (their outputs must stay bit-identical)."""
    buckets[ri % len(buckets)].extend(filter_fix_record(p, rec, lst))


def finalize_records(p: Params, records, per_record: list[list[Triplex]]
                     ) -> list[Triplex]:
    """Final filter then genome-coordinate fixup, concatenated in record
    order — through the `-C` bucket permutation when corenum >= 2."""
    buckets = corenum_buckets(p.corenum)
    for i, (rec, lst) in enumerate(zip(records, per_record)):
        finalize_record_into(buckets, p, i, rec, lst)
    return [t for b in buckets for t in b]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _process_batch(p: Params, rna: np.ndarray, q_idx: np.ndarray,
                   rna_b: bytes, meta: _ScanMeta, batch: list[_Work],
                   segs: np.ndarray, lengths: np.ndarray, eng, out, pool):
    """Wait for one batch's scan results and run its candidate stage (or,
    with -F, the exact SIM per segment); returns (work item, future ->
    hits) pairs in batch order.  Runs on a stage thread, inside the span
    `batch`."""
    STAGES.count("batches")
    if not p.do_fast_sim:
        # the SIM reads only the thresholds: no colmax row is fetched.
        # The kernels are exact at any length, so a threshold >= BYTE_SAT
        # needs no rerun here
        with STAGES.timer("device_wait"):
            gm = _host(out[0])
        return [(w, pool.submit(
            STAGES.spanned("host_candidate_busy", _host_segment_stage,
                           segment=i), p, rna, meta, w, gm[i], eng.device))
                for i, w in enumerate(batch)]
    thresh_dev, cm_dev = out[0], out[1]
    # the window passes reuse the batch's uploaded segment bytes
    segs_win = out[5] if len(out) > 5 else segs
    cm_cache: dict = {}

    def cm_get(sel):
        # full colmax rows: an int (one segment) or the (seg, scan) index
        # arrays of the overflow rows; a host slice once cm was fetched
        if "cm" in cm_cache:
            return cm_cache["cm"][sel]
        if isinstance(sel, tuple):
            sel = tuple(torch.as_tensor(a, device=cm_dev.device)
                        for a in sel)
        return _host(cm_dev[sel])

    def cm_fallback(i):
        # banded-traceback-error fallback (never observed): recompute the
        # batch's colmax rather than keep cm_dev alive in every closure;
        # the scan is deterministic, so the row is identical
        return _host(eng.scan_segments(segs, lengths)[1][i])

    with STAGES.timer("device_wait"):
        gm = _host(thresh_dev)
        packed = None
        if (gm >= BYTE_SAT).any():
            # fasim_tpu reruns such a batch with a full prefix, because
            # its windowed kernel is not exact there.  These kernels are
            # exact at any length, so the first pass's thresholds and
            # packed candidates (byte-break included) stand as they are
            STAGES.count("batches_saturated")
        if len(out) > 2:
            # count-then-slice fetch: the counts first, then only the
            # first kp candidate columns (kp = the batch's max count up a
            # small ladder); rows with cnt > kp take candidates.py's
            # full-row overflow path
            cnt = _host(out[4])
            kfull = out[2].shape[2]
            kmax = min(int(cnt.max(initial=0)), kfull)
            kp = next((b for b in (32, 64, 128, 256) if b >= kmax), kfull)
            packed = (_host(out[2][:, :, :kp]), _host(out[3][:, :, :kp]),
                      cnt)
        else:
            cm_cache["cm"] = _host(cm_dev)
    return candidate_stage_batch(p, rna, q_idx, rna_b, meta, batch,
                                 segs_win, lengths, gm, cm_get, packed, eng,
                                 pool, cm_fallback=cm_fallback)


class WatchdogError(RuntimeError):
    """A device batch or host finalize task made no progress within
    FASIM_WATCHDOG_S: its thread is wedged and never returns."""


def _engines(engine) -> list:
    """One engine or a list of per-device engines -> the list."""
    return list(engine) if isinstance(engine, (list, tuple)) else [engine]


def iter_scan_work(p: Params, rna: np.ndarray, work_iter, scans: list[dict],
                   engine, n_pad: int, batch_pairs: int = 64,
                   host_threads: int = 0, max_inflight: int = 4,
                   n_work_hint: int = -1):
    """Streaming scan core: consume a work iterator, keep at most
    `max_inflight` device batches in flight per engine, yield (work item,
    hits) in input order.  `engine` is one TorchScanEngine or a list of
    them (one a device); batch k goes to engine k mod the count
    (fasim_tpu/scan/batched.py:436-447).  `n_work_hint`, the number of
    work items when known (-1 otherwise), lets a small job skip the
    window warm."""
    engines = _engines(engine)
    with STAGES.timer("engine_setup"):
        for eng in engines:
            eng.setup_scans(scans)
            if p.do_fast_sim:
                eng.setup_windows(rna)
    if os.environ.get("FASIM_PREWARM", "1") == "1":
        # a small job (an H19-demo-sized input is one batch) skips the
        # window warm, as fasim_tpu's does
        small = 0 <= n_work_hint <= 2 * batch_pairs
        prewarm.prewarm_engines(engines, n_pad, batch_pairs,
                                p.do_fast_sim and not small)
    if host_threads <= 0:
        host_threads = min(32, os.cpu_count() or 1)
    max_inflight = max(max_inflight, 2) * len(engines)
    host_backlog = min(2 * max_inflight, 256)
    meta = _ScanMeta(scans)
    q_idx = np.ascontiguousarray(rules.SSW_ENC[rna], np.int32)
    rna_b = rna.tobytes()
    inflight: collections.deque = collections.deque()
    done: collections.deque = collections.deque()
    pool = ThreadPoolExecutor(max_workers=host_threads)
    # one stage thread per in-flight batch: a batch's window passes and
    # transfers overlap the next batches' scans (capped as in fasim_tpu)
    stages = ThreadPoolExecutor(max_workers=max(2, min(64, max_inflight)))
    # Watchdog: cap every blocking wait so that a wedged batch surfaces as
    # a clear error instead of an indefinite hang.  Kernel launches are
    # asynchronous, so a hung kernel blocks the `.cpu()` read-back in a
    # stage thread, and with it the stage batch's future; a stuck native
    # call blocks a host finalize future.
    wd = float(os.environ.get("FASIM_WATCHDOG_S", "1800"))
    wedged = False

    def _result(fut, what: str):
        nonlocal wedged
        try:
            return fut.result(timeout=wd)
        except FutTimeout:
            wedged = True
            raise WatchdogError(
                f"scan watchdog: {what} made no progress for {wd:.0f}s — "
                "a kernel or the device is likely wedged; rerun") from None

    def drain_done(min_keep: int):
        # pop finished stage batches (in order); block on the oldest
        # while more than min_keep are queued
        while done and (len(done) > min_keep or done[0].done()):
            with STAGES.timer("batch_wait"):
                finished = _result(done.popleft(), "a device batch")
            for w0, fut in finished:
                with STAGES.timer("host_candidate_wait"):
                    hits = _result(fut, "a host finalize task")
                yield w0, hits

    def dispatch(batch: list[_Work], k: int) -> None:
        segs = np.zeros((len(batch), n_pad), np.uint8)
        lengths = np.zeros(len(batch), np.int32)
        for i, w in enumerate(batch):
            segs[i, :len(w.segment)] = w.segment
            lengths[i] = len(w.segment)
        eng = engines[k % len(engines)]
        with STAGES.timer("prewarm_wait"):
            # the engine's warm jobs end before its first dispatch, and
            # a failed one raises here
            for fut in prewarm.pending(eng):
                _result(fut, "a warm job")
        with STAGES.timer("device_dispatch"):
            if p.do_fast_sim:
                out = eng.scan_segments_packed(segs, lengths)
            else:
                out = eng.scan_segments(segs, lengths)
        inflight.append(stages.submit(
            STAGES.spanned("batch", _process_batch, batch=k), p, rna, q_idx,
            rna_b, meta, batch, segs, lengths, eng, out, pool))

    try:
        nbatch = 0
        batch: list[_Work] = []
        for w in work_iter:
            batch.append(w)
            if len(batch) < batch_pairs:
                continue
            if len(inflight) >= max_inflight:
                done.append(inflight.popleft())
            yield from drain_done(min_keep=host_backlog)
            dispatch(batch, nbatch)
            nbatch += 1
            # return free heap to the OS every few batches (the arena cap
            # is applied at module import)
            if _LIBC is not None and nbatch % 8 == 0:
                _LIBC.malloc_trim(0)
            batch = []
        if batch:
            if len(inflight) >= max_inflight:
                done.append(inflight.popleft())
            dispatch(batch, nbatch)
        done.extend(inflight)
        inflight.clear()
        yield from drain_done(min_keep=0)
        # an engine that got no batch still raises its warm failure
        for eng in engines:
            for fut in prewarm.pending(eng):
                _result(fut, "a warm job")
    finally:
        # a wedged thread never returns: do not wait for it
        for ex in (stages, pool):
            ex.shutdown(wait=not wedged, cancel_futures=wedged)


def scan_work(p: Params, rna: np.ndarray, work: list[_Work],
              scans: list[dict], engine, batch_pairs: int = 64,
              host_threads: int = 0, max_inflight: int = 4
              ) -> list[tuple[_Work, list]]:
    """Scan an explicit work list; (work item, hits) pairs in its order.
    This is the shard-level entry of a caller that picks its own subset
    of the segments."""
    if not work:
        for eng in _engines(engine):
            eng.setup_scans(scans)
        return []
    n_max = max(len(w.segment) for w in work)
    n_pad = (n_max + 127) // 128 * 128
    return list(iter_scan_work(p, rna, iter(work), scans, engine, n_pad,
                               batch_pairs, host_threads, max_inflight,
                               n_work_hint=len(work)))


def scan_records(p: Params, records, rna: np.ndarray, engine,
                 batch_pairs: int = 64, host_threads: int = 0,
                 max_inflight: int = 4) -> list[list]:
    """Full scan of all records: one triplex list per record (before the
    genome-coordinate fixup)."""
    work, scans = enumerate_work(p, records)
    out: list[list] = [[] for _ in records]
    for w, found in scan_work(p, rna, work, scans, engine, batch_pairs,
                              host_threads, max_inflight):
        out[w.record_idx].extend(found)
    return out


def scan_file_batched(p: Params, engine, batch_pairs: int = 64,
                      host_threads: int = 0, max_inflight: int = 4):
    """Read the inputs, scan, filter: (records, lnc_name, rna, triplexes),
    the return contract of fasim_tpu.scan.batched.scan_file_batched."""
    with STAGES.timer("read_input"):
        records = fasta.read_dna(p.file1path)
        lnc_name, rna = fasta.read_rna(p.file2path)
    per_record = scan_records(p, records, rna, engine, batch_pairs,
                              host_threads, max_inflight)
    with STAGES.timer("finalize_records"):
        tlist = finalize_records(p, records, per_record)
    return records, lnc_name, rna, tlist


@dataclasses.dataclass
class RecordMeta:
    """Header metadata of a streamed record (sequence dropped)."""

    species: str
    chro_tag: str
    start_genome: int
    seq_len: int


def scan_file_stream(p: Params, engine, batch_pairs: int = 64,
                     host_threads: int = 0, max_inflight: int = 4,
                     spill_dir: str | None = None):
    """Genome-scale streaming scan: records read lazily (one in memory at
    a time), segments flow through the bounded-window driver, and each
    record's hits are filtered + coordinate-fixed as soon as the record
    completes, then appended to a columnar TriplexStore (numeric columns
    in RAM at ~60 B/hit; the alignment strings spill to a file in
    `spill_dir` — default FASIM_SPILL_DIR, else TMPDIR; an empty
    FASIM_SPILL_DIR keeps them in RAM — until TFOsorted-write time).
    Memory is O(dispatch window + current record + numeric hit columns),
    not O(genome).  Returns (record_metas, lnc_name, rna, store); the
    store yields output files byte-identical to scan_file_batched's list
    through post.output.print_result (tests/test_torch_stream.py)."""
    from ..post.store import TriplexStore

    lnc_name, rna = fasta.read_rna(p.file2path)
    metas: list[RecordMeta] = []

    def gen():
        for ri, rec in enumerate(fasta.iter_dna(p.file1path)):
            metas.append(RecordMeta(rec.species, rec.chro_tag,
                                    rec.start_genome, len(rec.seq)))
            segs, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                              p.overlap_length)
            for seg, start in zip(segs, starts):
                if fasta.same_seq(seg):
                    continue
                yield _Work(ri, start, seg)

    scans = rules.scan_list(p.rule, p.strand)
    # a segment is at most cut_length long; the records are not read
    # ahead for the longest one
    n_pad = (p.cut_length + 127) // 128 * 128
    nbuckets = max(1, p.corenum)
    if spill_dir is None:
        spill_dir = os.environ.get("FASIM_SPILL_DIR",
                                   tempfile.gettempdir())
    store = TriplexStore(spill_dir=spill_dir or None)

    def flush(ri: int, lst: list[Triplex]) -> None:
        with STAGES.timer("store_append"):
            store.add_record(ri % nbuckets, metas[ri].chro_tag,
                             filter_fix_record(p, metas[ri], lst))

    cur_ri = -1
    cur: list[Triplex] = []
    try:
        for w, found in iter_scan_work(p, rna, gen(), scans, engine, n_pad,
                                       batch_pairs, host_threads,
                                       max_inflight):
            if w.record_idx != cur_ri:
                if cur_ri >= 0:
                    flush(cur_ri, cur)
                cur_ri = w.record_idx
                cur = []
            cur.extend(found)
        if cur_ri >= 0:
            flush(cur_ri, cur)
    except BaseException:
        store.close()  # no output follows: remove the spill file now
        raise
    return metas, lnc_name, rna, store.finalize()
