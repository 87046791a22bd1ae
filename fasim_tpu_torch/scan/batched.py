"""Batched scan of the port.

Counterpart of fasim_tpu/scan/batched.py (iter_scan_work, scan_work,
scan_records, scan_file_batched) for a `TorchScanEngine`.  The host
helpers are that module's own (`_Work`, `enumerate_work`, `_ScanMeta`,
`finalize_records`; it imports no jax), and the candidate stage is
fasim_tpu/scan/candidates.py unchanged, so the output is byte-identical
to the JAX package's.  Differences from fasim_tpu.scan.batched:

  * no prewarm: CUDA kernels are not compiled per shape;
  * the packed candidates come back with one `.cpu()` of the pos / val
    slices after the counts, instead of `jax.device_get`;
  * only the fastSIM path (the candidate-window passes): `-F` and the
    streaming scan are not ported yet;
  * the default CUDA stream only.

Batches are dispatched up to `max_inflight` ahead; one stage thread per
in-flight batch waits for its device results and runs the candidate
stage, and the host finalize runs on a thread pool.  Results are yielded
in input order, so the output does not depend on the window or thread
counts.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fasim_tpu import rules
from fasim_tpu.config import BYTE_SAT, Params
from fasim_tpu.io import fasta
from fasim_tpu.profiling import STAGES
from fasim_tpu.scan.batched import (_ScanMeta, _Work, enumerate_work,
                                    finalize_records)
from fasim_tpu.scan.candidates import candidate_stage_batch


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _process_batch(p: Params, rna: np.ndarray, q_idx: np.ndarray,
                   rna_b: bytes, meta: _ScanMeta, batch: list[_Work],
                   segs: np.ndarray, lengths: np.ndarray, eng, out, pool):
    """Wait for one batch's scan results and run its candidate stage;
    returns (work item, future -> hits) pairs in batch order."""
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
            # fasim_tpu's byte->word escalation: its windowed kernel
            # needs a full-prefix rerun for thresholds >= BYTE_SAT.  This
            # kernel is exact at any length (the rerun returns the same
            # thresholds); the branch keeps fasim_tpu's control flow,
            # full colmax rows instead of the packed candidates
            gm = _host(eng.scan_segments(segs_win, lengths, full_prefix=True,
                                         host_segs=segs)[0])
            cm_cache["cm"] = _host(cm_dev)
        elif len(out) > 2:
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


def iter_scan_work(p: Params, rna: np.ndarray, work_iter, scans: list[dict],
                   engine, n_pad: int, batch_pairs: int = 64,
                   host_threads: int = 0, max_inflight: int = 4):
    """Streaming scan core: consume a work iterator, keep at most
    `max_inflight` device batches in flight, yield (work item, hits) in
    input order.  `engine` is one TorchScanEngine."""
    if not p.do_fast_sim:
        raise NotImplementedError("-F (exact SIM) is not ported to the "
                                  "torch port yet")
    engine.setup_scans(scans)
    engine.setup_windows(rna)
    if host_threads <= 0:
        host_threads = min(32, os.cpu_count() or 1)
    max_inflight = max(max_inflight, 2)
    host_backlog = min(2 * max_inflight, 256)
    meta = _ScanMeta(scans)
    q_idx = np.ascontiguousarray(rules.SSW_ENC[rna], np.int32)
    rna_b = rna.tobytes()
    inflight: collections.deque = collections.deque()
    done: collections.deque = collections.deque()
    # one stage thread per in-flight batch: a batch's window passes and
    # transfers overlap the next batches' scans
    with ThreadPoolExecutor(max_workers=host_threads) as pool, \
            ThreadPoolExecutor(max_workers=max_inflight) as stages:

        def drain_done(min_keep: int):
            # pop finished stage batches (in order); block on the oldest
            # while more than min_keep are queued
            while done and (len(done) > min_keep or done[0].done()):
                for w0, fut in done.popleft().result():
                    with STAGES.timer("host_candidate_wait"):
                        hits = fut.result()
                    yield w0, hits

        def dispatch(batch: list[_Work]) -> None:
            segs = np.zeros((len(batch), n_pad), np.uint8)
            lengths = np.zeros(len(batch), np.int32)
            for i, w in enumerate(batch):
                segs[i, :len(w.segment)] = w.segment
                lengths[i] = len(w.segment)
            with STAGES.timer("device_dispatch"):
                out = engine.scan_segments_packed(segs, lengths)
            inflight.append(stages.submit(
                _process_batch, p, rna, q_idx, rna_b, meta, batch, segs,
                lengths, engine, out, pool))

        batch: list[_Work] = []
        for w in work_iter:
            batch.append(w)
            if len(batch) < batch_pairs:
                continue
            if len(inflight) >= max_inflight:
                done.append(inflight.popleft())
            yield from drain_done(min_keep=host_backlog)
            dispatch(batch)
            batch = []
        if batch:
            if len(inflight) >= max_inflight:
                done.append(inflight.popleft())
            dispatch(batch)
        done.extend(inflight)
        inflight.clear()
        yield from drain_done(min_keep=0)


def scan_work(p: Params, rna: np.ndarray, work: list[_Work],
              scans: list[dict], engine, batch_pairs: int = 64,
              host_threads: int = 0, max_inflight: int = 4
              ) -> list[tuple[_Work, list]]:
    """Scan an explicit work list; (work item, hits) pairs in its order."""
    if not work:
        engine.setup_scans(scans)
        return []
    n_max = max(len(w.segment) for w in work)
    n_pad = (n_max + 127) // 128 * 128
    return list(iter_scan_work(p, rna, iter(work), scans, engine, n_pad,
                               batch_pairs, host_threads, max_inflight))


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
    records = fasta.read_dna(p.file1path)
    lnc_name, rna = fasta.read_rna(p.file2path)
    per_record = scan_records(p, records, rna, engine, batch_pairs,
                              host_threads, max_inflight)
    return records, lnc_name, rna, finalize_records(p, records, per_record)
