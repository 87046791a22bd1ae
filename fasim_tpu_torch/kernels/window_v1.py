"""K6 window_keys: the v1 candidate-window pass (FASIM_WIN_V1=1).

Replaces fasim_tpu/kernels/tpu.py:_window_kernel (pallas_call in
_window_call) with the glue around it: `decode_key` (tpu.py:_decode_key),
`ends_from_stats` (tpu.py:_ends_from_stats / window_stats_to_ends) and the
v1 row layouts of window_pass, _window_specs_call and _window_specs_call2
(`v1_rows`, `v1_ends`).  The kernel is csrc/window_v1.cu (its header says what bounds
it on the card and how the design meets that); `window_keys_ref` is its
plain PyTorch version, one query-row step at a time over (rows, W), as
the Pallas kernel steps.

The kernel's output is a stats key per window column:
(column max << 20) + (0xFFFFF - first row attaining it); a running max of
the keys keeps the larger max and, among equal maxima, the earliest row.
"""

from __future__ import annotations

import torch

from ..config import GAP_EXTEND, GAP_OPEN

from . import _build

KT_BITS = 20
KT_MASK = (1 << KT_BITS) - 1
_NEG = -(2 ** 30)

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


def window_keys(codes: torch.Tensor, qc: torch.Tensor, offs: torch.Tensor,
                mreals: torch.Tensor, m: int, subw: int = 0) -> torch.Tensor:
    """K6: keys int32[R, W] (see `window_keys_ref`).  CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    `window_keys.launches`); anything else raises."""
    if codes.device.type == "cpu":
        return window_keys_ref(codes, qc, offs, mreals, m, subw)
    if codes.device.type != "cuda":
        raise ValueError(f"window_keys: unsupported device {codes.device}")
    R, W = codes.shape
    if (W, subw) not in ((128, 0), (256, 0), (128, 64)) \
            or codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError("window_keys: codes must be contiguous uint8[rows, "
                         "W] with W 128 or 256 (subw 0), or 128 (subw 64)")
    nwin = W // (subw or W)
    for key, t, n in (("qc", qc, qc.shape[0]), ("offs", offs, R * nwin),
                      ("mreals", mreals, R * nwin)):
        if t.device != codes.device or t.dtype != torch.int32 \
                or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"window_keys: {key} must be contiguous "
                             f"int32[{n}] on {codes.device}")
    out = torch.empty(R, W, dtype=torch.int32, device=codes.device)
    lib = _build.lib()
    with torch.cuda.device(codes.device):
        err = lib.fasim_window_keys(
            codes.data_ptr(), R, W, subw, qc.data_ptr(), qc.shape[0],
            offs.data_ptr(), mreals.data_ptr(), m, out.data_ptr(),
            _build.stream_of(codes))
    _build.check(err, "fasim_window_keys")
    _build.count_launch(window_keys)
    return out


window_keys.launches = 0


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
    """Ends int32[n, 3] of n windows of one width class (codes uint8[n, w],
    w 64, 128 or 256; per-window int32[n] offs, terms, rlens, mreals)
    through K6 in the rows of `v1_rows`; the ends reduction runs per
    window over its w lanes."""
    n, w = codes.shape
    rows, o, mr, subw = v1_rows(codes, offs, mreals)
    keys = window_keys(rows, qc, o, mr, m, subw)
    mx, mrow = decode_key(keys.reshape(-1, w)[:n])
    return ends_from_stats(mx, mrow, terms, rlens, m)
