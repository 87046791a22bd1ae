"""Batched NumPy engine for the two hot DP passes.

Computes, for one DNA segment and all its rule transforms at once, the
threshold-pass global max (stats.h calc_score_once) and the scan-pass column
maxima (sswNew.cpp sw_sse2_byte_once) by carrying the DP column state with a
leading transform axis.  Bit-identical to the scalar golden kernels in
`ref.py` (same recurrence, same byte-break rule), just vectorized;
kernels/engine.py:TorchScanEngine has the same contract.

Contract (engines are swappable):
    thresh, colmax = engine(rna_u8, seq2_list)
      thresh: int32[T]      (T = number of transforms)
      colmax: int32[T, N]   (N = segment length; transforms shorter than N
                             are right-padded with zeros — see note below)

All transformed strings of one segment have the segment's length (rule
transforms are 1:1; reversal preserves length), so no padding is needed in
practice; an assert guards the assumption.
"""

from __future__ import annotations

import numpy as np

from ..config import BYTE_SAT, GAP_EXTEND, GAP_OPEN
from ..rules import SSW_ENC, SSW_MAT, THRESH_ENC, THRESH_MAT


def _batched_colmax_and_max(q_idx: np.ndarray, r_idx: np.ndarray,
                            mat: np.ndarray, lanes: int,
                            byte_break: bool) -> tuple[np.ndarray, np.ndarray]:
    """DP over T transforms at once.

    q_idx: int[M] query codes; r_idx: int[T, N] per-transform ref codes.
    Returns (global_max int32[T], colmax int32[T, N]).
    """
    T, N = r_idx.shape
    M = len(q_idx)
    pad = (-M) % lanes
    Mp = M + pad
    matq = np.vstack([mat[q_idx], np.zeros((pad, mat.shape[1]), mat.dtype)])
    H = np.zeros((T, Mp), dtype=np.int32)
    E = np.zeros((T, Mp), dtype=np.int32)
    colmax = np.zeros((T, N), dtype=np.int32)
    gmax = np.zeros(T, dtype=np.int32)
    running = np.zeros(T, dtype=np.int32)
    broken = np.zeros(T, dtype=bool)
    go, ge = GAP_OPEN, GAP_EXTEND
    idx = np.arange(Mp, dtype=np.int64)
    fbias = idx * ge
    foff = go + (idx - 1) * ge
    NEG = np.int64(np.iinfo(np.int64).min // 2)
    for j in range(N):
        s_col = matq[:, r_idx[:, j]].T  # (T, Mp)
        E = np.maximum(E - ge, H - go)
        diag = np.empty_like(H)
        diag[:, 0] = 0
        diag[:, 1:] = H[:, :-1]
        tmp = np.maximum(np.maximum(diag + s_col, E), 0)
        run = np.maximum.accumulate(tmp.astype(np.int64) + fbias, axis=1)
        F = np.empty((T, Mp), dtype=np.int64)
        F[:, 0] = NEG
        F[:, 1:] = run[:, :-1] - foff[1:]
        H = np.maximum(tmp, F).astype(np.int32)
        cm = H.max(axis=1)
        np.maximum(gmax, cm, out=gmax)
        if byte_break:
            newly = (~broken) & (cm > running) & (cm >= BYTE_SAT)
            broken |= newly
            rec = np.where(broken, 0, cm)
            colmax[:, j] = rec
            np.maximum(running, np.where(broken, running, cm), out=running)
        else:
            colmax[:, j] = cm
    return gmax, colmax


def numpy_engine(rna: np.ndarray, seq2_list: list[np.ndarray]
                 ) -> tuple[np.ndarray, np.ndarray]:
    """thresh[T], colmax[T, N] for one segment's transform list."""
    n = len(seq2_list[0])
    assert all(len(s) == n for s in seq2_list)
    seq2 = np.stack(seq2_list)
    thresh, _ = _batched_colmax_and_max(
        THRESH_ENC[rna], THRESH_ENC[seq2], THRESH_MAT, 16, False)
    _, colmax = _batched_colmax_and_max(
        SSW_ENC[rna], SSW_ENC[seq2], SSW_MAT, 16, True)
    return thresh, colmax
