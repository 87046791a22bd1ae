"""Affine-gap local alignment (gap open 16, extend 4) in plain PyTorch.

The textbook int32 recurrence, one DNA column a step, with every row of
the query at once and a batch of independent matrices beside each other.
Its value equals the reference's SSE2 kernels' (sswNew.cpp, stats.h) on
every cell they record: a gap that follows a gap in the other direction
costs more than a mismatch, so the lazy-F kernels compute the same cells,
and the 8-bit kernels either escalate to exact words or stop recording
before a cell saturates.

Rows past a query's length are the striped kernels' phantom rows (score 0
against every base, the query rounded up to its lanes).  Rows past
`rows[b]` do not exist: a row only reads the rows above it, so they never
reach a real one, and the column maxima leave them out.
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import BYTE_SAT, GAP_EXTEND, GAP_OPEN

NEG = -(1 << 40)


class Columns:
    """The DP state of B matrices of R rows: H and E of the last column."""

    def __init__(self, score: torch.Tensor, rows: torch.Tensor):
        # score: int32 [B, R, A], each row's score against each code
        self.score = score
        B, R, _ = score.shape
        dev = score.device
        self.H = torch.zeros(B, R, dtype=torch.int32, device=dev)
        self.E = torch.zeros(B, R, dtype=torch.int32, device=dev)
        idx = torch.arange(R, device=dev, dtype=torch.int64)
        self.fbias = idx * GAP_EXTEND
        self.foff = GAP_OPEN + (idx - 1) * GAP_EXTEND
        self.exists = idx[None, :] < rows[:, None].to(dev)

    def step(self, codes: torch.Tensor) -> torch.Tensor:
        """Advance every matrix by the column of `codes` int64[B]; return
        each one's column maximum over its existing rows."""
        s = torch.gather(self.score, 2,
                         codes.view(-1, 1, 1).expand(-1, self.H.shape[1], 1)
                         ).squeeze(2)
        E = torch.maximum(self.E - GAP_EXTEND, self.H - GAP_OPEN)
        diag = torch.nn.functional.pad(self.H[:, :-1], (1, 0))
        tmp = torch.clamp_min(torch.maximum(diag + s, E), 0)
        run = torch.cummax(tmp.to(torch.int64) + self.fbias, dim=1).values
        F = torch.nn.functional.pad(run[:, :-1] - self.foff[1:], (1, 0),
                                    value=NEG)
        self.H = torch.maximum(tmp.to(torch.int64), F).to(torch.int32)
        self.E = E
        return torch.where(self.exists, self.H, 0).amax(dim=1)


def score_rows(q_codes: np.ndarray, mat: np.ndarray, rows: int
               ) -> np.ndarray:
    """int32 [rows, A]: each query row's score against each code, zero
    on the phantom rows past the query."""
    out = np.zeros((rows, mat.shape[1]), np.int32)
    out[:len(q_codes)] = mat[q_codes]
    return out


def scan_pass(q_codes: np.ndarray, mat: np.ndarray, r_codes: np.ndarray,
              lens: np.ndarray, byte_break: bool, device,
              lanes: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """One query against B sequences (r_codes int64[B, N], row b of
    length lens[b]): the global maximum int64[B] and the column maxima
    int64[B, N].  With byte_break a matrix stops recording at the first
    column whose maximum raises its running maximum to BYTE_SAT or more,
    that column included, and the rest stay 0 (sswNew.cpp:384-386)."""
    B, N = r_codes.shape
    m = len(q_codes)
    rows = m + (-m) % lanes
    prof = torch.as_tensor(score_rows(q_codes, mat, rows), device=device)
    cols = Columns(prof[None].expand(B, -1, -1),
                   torch.full((B,), rows, dtype=torch.int64))
    codes = torch.as_tensor(r_codes, device=device)
    lens_t = torch.as_tensor(lens, device=device)
    gmax = torch.zeros(B, dtype=torch.int32, device=device)
    running = torch.zeros(B, dtype=torch.int32, device=device)
    broken = torch.zeros(B, dtype=torch.bool, device=device)
    colmax = torch.zeros(B, N, dtype=torch.int32, device=device)
    for j in range(N):
        cm = cols.step(codes[:, j])
        live = lens_t > j
        cm = torch.where(live, cm, 0)
        gmax = torch.maximum(gmax, cm)
        if byte_break:
            broken |= live & (cm > running) & (cm >= BYTE_SAT)
            colmax[:, j] = torch.where(broken, 0, cm)
            running = torch.where(broken, running,
                                  torch.maximum(running, cm))
        else:
            colmax[:, j] = cm
    return gmax.cpu().numpy().astype(np.int64), \
        colmax.cpu().numpy().astype(np.int64)


def end_pass(score: torch.Tensor, rows: np.ndarray, real: np.ndarray,
             r_codes: np.ndarray, lens: np.ndarray,
             terminate: np.ndarray | None, device
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The striped aligner's end-finding pass (sswNew.cpp:591-630) on B
    windows at once: score int32[B, R, A] (each window's query rows),
    rows[b] the rows that exist (the query and its phantom rows), real[b]
    the query's own, r_codes int64[B, L] the window's bases in scan
    order, lens[b] its length.  A window stops after the first column
    whose maximum equals terminate[b] when given.  Returns (best, the
    column of its last strict rise, the first real row holding it there,
    or real - 1 when only phantom rows do); column -1 when best is 0."""
    B, L = r_codes.shape
    cols = Columns(score, torch.as_tensor(rows))
    R = score.shape[1]
    dev = score.device
    codes = torch.as_tensor(r_codes, device=dev)
    lens_t = torch.as_tensor(lens, device=dev)
    real_t = torch.as_tensor(real, device=dev)
    is_real = torch.arange(R, device=dev)[None, :] < real_t[:, None]
    term = (torch.as_tensor(terminate, device=dev) if terminate is not None
            else None)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    end_col = torch.full((B,), -1, dtype=torch.int64, device=dev)
    end_row = real_t - 1
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    big = torch.tensor(R, device=dev)
    for j in range(L):
        cm = cols.step(codes[:, j])
        live = (lens_t > j) & ~done
        rise = live & (cm > best)
        if bool(rise.any()):
            hit = (cols.H == cm[:, None]) & is_real
            first = torch.where(hit.any(dim=1),
                                torch.argmax(hit.to(torch.int8), dim=1),
                                torch.minimum(real_t - 1, big))
            best = torch.where(rise, cm, best)
            end_col = torch.where(rise, j, end_col)
            end_row = torch.where(rise, first, end_row)
        if term is not None:
            done |= live & (cm == term)
    return (best.cpu().numpy().astype(np.int64), end_col.cpu().numpy(),
            end_row.cpu().numpy())
