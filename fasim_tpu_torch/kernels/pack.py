"""Device-side candidate packing of the scan pass's column maxima.

Counterpart of fasim_tpu/kernels/tpu.py:_pack_candidates, which is XLA
glue, not a Pallas kernel; here it is plain torch ops on the engine's
device.  Per (segment, transform) row: the byte-break zeroes the columns
from the first one >= BYTE_SAT on, the candidates are the columns within
the segment length whose max exceeds 4*thresh//5 (the reference's
trunc(0.8 * thresh), exact for every t < 2^50), and the first k of them
are returned in ascending position.  cnt > k flags the row for the
host's full-row fallback.

`pack_candidates_np` is the host mirror (tpu.py:pack_candidates_np),
kept here because the port never imports the JAX package's kernel modules.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import BYTE_SAT


def pack_candidates(thresh: torch.Tensor, cm_u8: torch.Tensor,
                    lengths: torch.Tensor, k: int):
    """thresh int32[S, T], cm_u8 uint8[S, T, N], lengths int32[S] ->
    (pos int16[S, T, k], val uint8[S, T, k], cnt int32[S, T])."""
    S, T, N = cm_u8.shape
    dev = cm_u8.device
    cm = cm_u8.to(torch.int32)
    lane = torch.arange(N, dtype=torch.int32, device=dev)
    sat = cm >= BYTE_SAT
    first = torch.where(sat.any(-1), sat.to(torch.uint8).argmax(-1),
                        torch.full((), N, device=dev))
    cmb = torch.where(lane < first[..., None], cm, 0)
    ms = 4 * thresh.to(torch.int32) // 5
    mask = (cmb > ms[..., None]) & (lane < lengths.to(torch.int32)[:, None,
                                                                    None])
    cnt = mask.sum(-1, dtype=torch.int32)
    # the k smallest keys are the first k candidate positions in order
    key = torch.where(mask, lane, N + lane)
    kk = min(k, N)
    pos = torch.topk(key, kk, dim=-1, largest=False, sorted=True).values
    good = pos < N
    posc = torch.where(good, pos, 0)
    val = torch.where(good, torch.gather(cmb, -1, posc.long()), 0)
    out_pos = torch.zeros(S, T, k, dtype=torch.int16, device=dev)
    out_val = torch.zeros(S, T, k, dtype=torch.uint8, device=dev)
    out_pos[..., :kk] = posc.to(torch.int16)
    out_val[..., :kk] = val.to(torch.uint8)
    return out_pos, out_val, cnt


def pack_candidates_np(thresh: np.ndarray, cm_u8: np.ndarray,
                       lengths: np.ndarray, k: int):
    """Host mirror of pack_candidates (same outputs as numpy arrays)."""
    S, T, N = cm_u8.shape
    pos = np.zeros((S, T, k), np.int16)
    val = np.zeros((S, T, k), np.uint8)
    cnt = np.zeros((S, T), np.int32)
    for s in range(S):
        for t in range(T):
            row = cm_u8[s, t].astype(np.int32)
            satj = np.flatnonzero(row >= BYTE_SAT)
            stop = int(satj[0]) if len(satj) else N
            stop = min(stop, int(lengths[s]))
            ms = 4 * int(thresh[s, t]) // 5
            cand = np.flatnonzero(row[:stop] > ms)
            cnt[s, t] = len(cand)
            take = cand[:k]
            pos[s, t, :len(take)] = take
            val[s, t, :len(take)] = row[take]
    return pos, val, cnt
