"""K6: the v1 candidate-window pass (FASIM_WIN_V1=1).

Replaces fasim_tpu/kernels/tpu.py:_window_kernel (pallas_call in
_window_call) with the glue around it: `decode_key` (tpu.py:_decode_key),
`ends_from_stats` (tpu.py:_ends_from_stats / window_stats_to_ends) and the
v1 row layouts of window_pass, _window_specs_call and _window_specs_call2
(`v1_rows`).  `window_v1` is the pass: ends int32[n, 3] of one width
class.  On the card it launches K6's kernel (csrc/window_v1.cu:
fasim_window_v1, K4's pair sweep of csrc/window_pairs.cuh with v1's
statistics and the ends reduced in the kernel), with 16-bit row keys, or,
when the query rows pass K6_MAX_NQ, in the sweep's long form
(`window_v1_long`, the keys folded by chunks of 65,536 rows).  The header
of csrc/window_v1.cu says what bounds the kernel on the card and how the
design meets that.

The plain chain is `v1_ends` on `window_keys_ref`, the Pallas kernel's
steps one query row at a time over (rows, W): a stats key per window
column, (column max << 20) + (0xFFFFF - first row attaining it); a running
max of the keys keeps the larger max and, among equal maxima, the earliest
row; the ends come from the keys.
"""

from __future__ import annotations

import torch

from ..config import GAP_EXTEND, GAP_OPEN

from . import _build
from .window import (LONG_MAX_ROWS, WIDTHS, _check_tab, _launch_pairs,
                     _on_card)

KT_BITS = 20
KT_MASK = (1 << KT_BITS) - 1
_NEG = -(2 ** 30)
# K6's kernel keys the rows t < min(mreal, nq) in 16 bits while the query
# rows nq <= K6_MAX_NQ; longer queries take its long form, window_v1_long
K6_MAX_NQ = 1 << 16

def query_rows(m: int) -> int:
    """Query rows the v1 pass streams: every phantom bound mreal <= m + 15
    is reachable, padded to 128-row chunks (tpu.py:461)."""
    return (m + 15 + 127) // 128 * 128


def window_keys_ref(codes: torch.Tensor, qc: torch.Tensor,
                    offs: torch.Tensor, mreals: torch.Tensor, m: int,
                    subw: int = 0) -> torch.Tensor:
    """Plain version of K6 (tpu.py:_window_kernel, step for step).

    codes uint8[R, W]; qc int32[nq] query codes (-1 past m); offs / mreals
    int32[R * (W // subw)] per window (subw 0: one window per row) ->
    keys int32[R, W]."""
    R, W = codes.shape
    sub = subw or W
    nwin = W // sub
    dev = codes.device
    lidx = torch.arange(W, dtype=torch.int32, device=dev)
    lmod = lidx % sub
    off = offs.to(torch.int32).view(R, nwin).repeat_interleave(sub, 1)
    mreal = mreals.to(torch.int32).view(R, nwin).repeat_interleave(sub, 1)
    fbias = lmod * GAP_EXTEND
    foff = GAP_OPEN + (lmod - 1) * GAP_EXTEND
    h = torch.zeros(R, W, dtype=torch.int32, device=dev)
    e = torch.zeros_like(h)
    mk = torch.full((R, W), KT_MASK - (m - 1), dtype=torch.int32,
                    device=dev)
    c = codes.to(torch.int32)
    # rows at or past every window's mreal change no key
    stop = min(qc.shape[0], int(mreals.max()) if R else 0)
    for t in range(stop):
        qt = qc[t]
        # SSW: 5 iff the query base is real and equal, else -4; zero
        # profile below the offset and on phantom rows
        s = ((c == qt) & (qt < 4)).to(torch.int32) * 9 - 4
        s = torch.where((t >= off) & (t < m), s, 0)
        ev = torch.maximum(e - GAP_EXTEND, h - GAP_OPEN)
        diag = torch.where(lmod >= 1, torch.roll(h, 1, 1), 0)
        tmp = torch.maximum(diag + s, ev).clamp_min_(0)
        run = tmp + fbias
        k = 1
        while k < sub:
            run = torch.maximum(
                run, torch.where(lmod >= k, torch.roll(run, k, 1), 0))
            k *= 2
        fv = torch.where(lmod >= 1, torch.roll(run, 1, 1), _NEG) - foff
        h = torch.maximum(tmp, fv)
        e = ev
        key = (h << KT_BITS) + (KT_MASK - t)
        mk = torch.maximum(mk, torch.where(t < mreal, key, 0))
    return mk


def _check_ints(name: str, codes: torch.Tensor, arrays: dict) -> None:
    """Each of arrays' (tensor, length) a contiguous int32[length] on
    codes' device, else ValueError."""
    for key, (t, n) in arrays.items():
        if t.device != codes.device or t.dtype != torch.int32 \
                or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous int32[{n}] "
                             f"on {codes.device}")


def decode_key(mk: torch.Tensor):
    """Stats key -> (column max, first attaining row) (tpu.py:_decode_key)."""
    return mk >> KT_BITS, KT_MASK - (mk & KT_MASK)


def ends_from_stats(mx: torch.Tensor, mrow: torch.Tensor,
                    terms: torch.Tensor, rlens: torch.Tensor,
                    m: int) -> torch.Tensor:
    """Per-lane (column max, first attaining row) int32[R, W] -> the
    scan-order ends (best, end_col, end_row) int32[R, 3]
    (tpu.py:_ends_from_stats): the first lane < rlen whose max equals
    terms (terms >= 0) is the break column, later lanes are cut off;
    end_col is the first lane attaining the best; best <= 0 gives
    (0, -1, m - 1)."""
    W = mx.shape[1]
    li = torch.arange(W, device=mx.device)[None, :]
    terms = terms.long()[:, None]
    valid = li < rlens.long()[:, None]
    eqt = valid & (mx == terms) & (terms >= 0)
    # argmax gives the first maximal index
    limit = torch.where(eqt.any(1), eqt.int().argmax(1), W - 1)
    mxv = torch.where(valid & (li <= limit[:, None]), mx, 0)
    best = mxv.amax(1)
    ecol = (mxv == best[:, None]).int().argmax(1)
    erow = mrow.gather(1, ecol[:, None])[:, 0]
    none = best <= 0
    cols = (best, torch.where(none, -1, ecol), torch.where(none, m - 1, erow))
    return torch.stack([c.to(torch.int32) for c in cols], 1)


def v1_rows(codes: torch.Tensor, offs: torch.Tensor,
            mreals: torch.Tensor):
    """K6's rows for n windows of one width class, codes uint8[n, w] and
    per-window int32[n] offs / mreals -> (rows, offs, mreals, subw): w =
    128 / 256 one window per row (_window_specs_call, window_pass); w = 64
    two per 128-column row, windows 2i and 2i + 1 as its halves A and B
    (_window_specs_call2), an odd n padded with a window of pad codes and
    mreal 0, which sweeps no query row (tpu.py:683's fills)."""
    if codes.shape[1] != 64:
        return codes, offs, mreals, 0
    if codes.shape[0] % 2:
        codes = torch.cat([codes, torch.full_like(codes[:1], 4)])
        zero = offs.new_zeros(1)
        offs, mreals = torch.cat([offs, zero]), torch.cat([mreals, zero])
    return codes.reshape(-1, 128), offs, mreals, 64


def v1_ends(codes: torch.Tensor, qc: torch.Tensor, offs: torch.Tensor,
            terms: torch.Tensor, rlens: torch.Tensor, mreals: torch.Tensor,
            m: int) -> torch.Tensor:
    """K6's plain chain: ends int32[n, 3] of n windows of one width class
    (codes uint8[n, w], w 64, 128 or 256; per-window int32[n] offs, terms,
    rlens, mreals) through `window_keys_ref` in the rows of `v1_rows`, the
    ends reduced per window over its w lanes."""
    n, w = codes.shape
    rows, o, mr, subw = v1_rows(codes, offs, mreals)
    mx, mrow = decode_key(window_keys_ref(rows, qc, o, mr, m,
                                          subw).reshape(-1, w)[:n])
    return ends_from_stats(mx, mrow, terms, rlens, m)


def _v1(name: str, codes: torch.Tensor, qc: torch.Tensor,
        offs: torch.Tensor, terms: torch.Tensor, rlens: torch.Tensor,
        mreals: torch.Tensor, m: int, tab: torch.Tensor,
        wide: bool) -> torch.Tensor:
    """K6's checks, then its launch in the form `wide` picks (none for no
    windows)."""
    n, W = codes.shape
    if W not in WIDTHS or codes.dtype != torch.uint8 \
            or not codes.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous uint8[rows, W] "
                         f"with W in {WIDTHS}")
    nq = qc.numel()
    _check_ints(name, codes, {
        "qc": (qc, nq), "offs": (offs, n), "terms": (terms, n),
        "rlens": (rlens, n), "mreals": (mreals, n)})
    if n == 0:
        return torch.empty(0, 3, dtype=torch.int32, device=codes.device)
    _check_tab(name, tab, codes, nq - 1)
    if nq <= m:
        raise ValueError(f"{name}: {nq} query rows for m = {m}")
    return _launch_pairs("fasim_window_v1", codes, offs, terms, rlens,
                         mreals, m, tab, nq, wide)


def window_v1(codes: torch.Tensor, qc: torch.Tensor, offs: torch.Tensor,
              terms: torch.Tensor, rlens: torch.Tensor, mreals: torch.Tensor,
              m: int, tab: torch.Tensor) -> torch.Tensor:
    """K6: ends int32[n, 3] of n windows of one width class (codes uint8[n,
    W], W in WIDTHS; per-window int32[n] offs, terms, rlens, mreals; qc
    int32[nq] the query codes, -1 past m; tab = score_table of the same
    query, at least nq rows).  Query rows nq > K6_MAX_NQ go to
    `window_v1_long` (by shape: nothing is read back from the card).  Else
    CPU tensors take the plain chain `v1_ends`; CUDA tensors launch K6's
    kernel with 16-bit row keys (counted in `window_v1.launches`)."""
    if qc.numel() > K6_MAX_NQ:
        return window_v1_long(codes, qc, offs, terms, rlens, mreals, m, tab)
    if not _on_card("window_v1", codes):
        return v1_ends(codes, qc, offs, terms, rlens, mreals, m)
    out = _v1("window_v1", codes, qc, offs, terms, rlens, mreals, m, tab,
              False)
    if len(out):
        _build.count_launch(window_v1)
    return out


def window_v1_long(codes: torch.Tensor, qc: torch.Tensor,
                   offs: torch.Tensor, terms: torch.Tensor,
                   rlens: torch.Tensor, mreals: torch.Tensor, m: int,
                   tab: torch.Tensor) -> torch.Tensor:
    """K6's long form, the same pass with the row keys folded by chunks of
    65,536 rows (csrc/window_pairs.cuh): what `window_v1` runs for nq >
    K6_MAX_NQ; called directly, it runs any nq <= LONG_MAX_ROWS.  CPU
    tensors take `v1_ends`; CUDA tensors launch the kernel (counted in
    `window_v1_long.launches`)."""
    if not _on_card("window_v1_long", codes):
        return v1_ends(codes, qc, offs, terms, rlens, mreals, m)
    if qc.numel() > LONG_MAX_ROWS:
        raise ValueError(f"window_v1_long: {qc.numel()} query rows > "
                         f"{LONG_MAX_ROWS}")
    out = _v1("window_v1_long", codes, qc, offs, terms, rlens, mreals, m,
              tab, True)
    if len(out):
        _build.count_launch(window_v1_long)
    return out


window_v1.launches = 0
window_v1_long.launches = 0
