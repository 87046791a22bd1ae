"""A saturated batch (a threshold >= BYTE_SAT) takes the packed candidate
fetch in `scan/batched.py`, with no rerun: on such rows the device
packing (`pack_candidates`) then `native.segment_peaks_packed`, with the
fetch's kp ladder and its cnt > kp rows through `native.segment_peaks`
on full rows, gives the peaks that `native.segment_peaks` gives on the
full uint8 rows, in the same order.

The rows are built by hand: thresholds of 251, 300 and more on one scan
of every segment (below 251 on the others), a byte-break column before,
at or after the segment's length, segments shorter than the padded
width, and optionally a row with more candidates than the packing keeps.
`_process_batch` itself makes the fetch; the candidate stage is
stubbed out, and its peak step (scan/candidates.py, step 1) is mirrored
here.  Every value is an integer: the comparison is exact."""

import numpy as np
import pytest
import torch

from fasim_tpu_torch import native
from fasim_tpu_torch.config import BYTE_SAT, Params
from fasim_tpu_torch.kernels.engine import TorchScanEngine
from fasim_tpu_torch.kernels.pack import pack_candidates
from fasim_tpu_torch.profiling import STAGES
from fasim_tpu_torch.scan import batched

N = 1024                          # the batch's padded width
LENGTHS = (N, 1000, 700, 333)     # one full segment, three shorter
T = 6                             # scans a segment
K = TorchScanEngine.PACK_K        # candidate columns the packing keeps


def _rows(thresh0: int, brk: str, overflow: bool, seed: int = 5):
    """(thresh int32[S, T], cm uint8[S, T, N]): scan 0 of every segment
    holds `thresh0`, the others 100-250; background column maxima below
    every cut, runs of candidates (201-250) in each row, a byte-break
    column (251-255) in every row at the place `brk` names, and with
    `overflow` one row with more than K candidates."""
    rng = np.random.default_rng(seed)
    S = len(LENGTHS)
    thresh = rng.integers(100, BYTE_SAT, (S, T)).astype(np.int32)
    thresh[:, 0] = thresh0
    cm = rng.integers(0, 80, (S, T, N)).astype(np.uint8)
    for s, n in enumerate(LENGTHS):
        for t in range(T):
            for _ in range(rng.integers(2, 6)):
                a = int(rng.integers(0, n - 12))
                w = int(rng.integers(1, 12))
                cm[s, t, a:a + w] = rng.integers(201, BYTE_SAT, w)
            # a run a saturated scan keeps: above 0.8 x 300
            cm[s, t, 10:20] = 245
            col = {"before": n // 2, "at": n, "after": n + 5}[brk]
            if col < N:
                cm[s, t, col] = rng.integers(BYTE_SAT, 256)
    if overflow:
        # every column of scan 1 of the first segment above its cut,
        # up to the byte-break
        thresh[0, 1] = 100
        cm[0, 1, :N // 2] = rng.integers(81, BYTE_SAT, N // 2)
    return thresh, cm


def _batch_fetch(thresh, cm, monkeypatch):
    """Run `_process_batch` on the packed outputs of (thresh, cm), as
    `scan_segments_packed` returns them, and return what it hands the
    candidate stage: (gm, cm_get, packed)."""
    lengths = np.asarray(LENGTHS, np.int32)
    segs = np.zeros((len(LENGTHS), N), np.uint8)
    thresh_t, cm_t = torch.from_numpy(thresh), torch.from_numpy(cm)
    out = (thresh_t, cm_t,
           *pack_candidates(thresh_t, cm_t, torch.from_numpy(lengths), K),
           torch.from_numpy(segs))
    seen = {}

    def stage(p, rna, q_idx, rna_b, meta, batch, segs_win, lens, gm,
              cm_get, packed, eng, pool, cm_fallback=None):
        seen.update(gm=gm, cm_get=cm_get, packed=packed)
        return []

    def no_rerun(*args, **kw):
        raise AssertionError("the batch was scanned again")

    class Engine:
        scan_segments = scan_segments_packed = no_rerun

    monkeypatch.setattr(batched, "candidate_stage_batch", stage)
    batch = [batched._Work(0, 0, np.zeros(n, np.uint8)) for n in LENGTHS]
    STAGES.start_run()
    assert batched._process_batch(Params(), None, None, b"", None, batch,
                                  segs, lengths, Engine(), out, None) == []
    assert STAGES.report()["n_batches_saturated"] == 1
    return seen["gm"], seen["cm_get"], seen["packed"]


def _packed_peaks(gm, cm_get, packed):
    """The candidate stage's peak step on the packed route: per segment,
    the packed candidates' peaks, then each cnt > kp row's from its full
    row, ordered by scan (scan/candidates.py, step 1)."""
    pos, val, cnt = packed
    kp = pos.shape[2]
    over = np.argwhere(cnt > kp)
    rows = {}
    if len(over):
        fetched = cm_get((over[:, 0].astype(np.int64),
                          over[:, 1].astype(np.int64)))
        rows = {(int(i), int(k)): r for (i, k), r in zip(over, fetched)}
    peaks = []
    for i, n in enumerate(LENGTHS):
        c = cnt[i].copy()
        ks = [k for (si, k) in rows if si == i]
        c[ks] = 0
        parts = [native.segment_peaks_packed(pos[i], val[i], c)]
        for k in ks:
            pk = native.segment_peaks(rows[(i, k)][None, :], N,
                                      gm[i, k:k + 1], n)
            pk[:, 0] = k
            parts.append(pk)
        pk = np.concatenate(parts)
        peaks.append(pk[np.argsort(pk[:, 0], kind="stable")])
    return peaks, over


@pytest.mark.parametrize("overflow", [False, True],
                         ids=["fits", "overflow"])
@pytest.mark.parametrize("brk", ["before", "at", "after"])
@pytest.mark.parametrize("thresh0", [251, 300, 1000, 40000])
def test_packed_peaks_equal_full_rows(thresh0, brk, overflow, monkeypatch):
    thresh, cm = _rows(thresh0, brk, overflow)
    gm, cm_get, packed = _batch_fetch(thresh, cm, monkeypatch)
    # the first pass's thresholds, the packed route
    np.testing.assert_array_equal(gm, thresh)
    assert packed is not None
    got, over = _packed_peaks(gm, cm_get, packed)
    assert [tuple(o) for o in over] == ([(0, 1)] if overflow else [])
    if not overflow:
        assert packed[0].shape[2] < K  # the ladder cut the fetch
    n_peaks = 0
    for i, n in enumerate(LENGTHS):
        want = native.segment_peaks(cm[i], N, thresh[i], n)
        np.testing.assert_array_equal(got[i], want)
        n_peaks += len(want)
        kept = want[want[:, 0] == 0]  # the saturated scan's peaks
        if thresh0 <= 300:
            assert len(kept) > 0
        else:
            # 0.8 x thresh lies above every byte a row can hold
            assert len(kept) == 0
    assert n_peaks > len(LENGTHS) * (T - 1)
