"""K3 window_fwd and K4 window_general: the candidate-window passes.

Replace fasim_tpu/kernels/tpu.py:_wfwd_kernel (K3: the uniform forward
specs — off 0, mreal m16, no terms, dirn +1) and _wscan_kernel (K4:
per-row offs, mreals, terms, dirn +-1) together with their ends
reductions (_ends_from_lane_keys, _ends_from_stats).  K3 is
csrc/window_fwd.cu and K4 csrc/window_gen.cu, both two windows per
register in 16-bit cells (csrc/window_s16.cuh), K4 with each window swept
from its own offset (the pair sweep csrc/window_pairs.cuh, which K6
shares); their headers say what bounds them on the card and how the
designs meet that.  Both key query rows in 16 bits; queries longer than
K3_MAX_M rows take the pair sweep's long form (`window_general_long`,
which folds the keys by chunks of 65,536 rows), routed by shape.  All
return the ends int32[rows, 3] = (best, end_col, end_row) directly.
`window_pass_ref` is their plain PyTorch version, ported from
kernels/xla.py:window_pass_xla.

Also here: the window query rows (`window_qp`, xla.py:_window_qp), the
per-row score table of K3 and K4 (`score_table`) and their row orders
(`pair_order`, `offset_order`), and the device-side window gather
(`gather_window_codes`, the gather of tpu.py:_wspecs_call /
_wspecs_fwd_call and xla.py:build_window_codes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GAP_EXTEND, GAP_OPEN
from ..rules import SSW_ENC

from . import _build
from .scan import reverse_prefix

_NEG = -(2 ** 30)
_BIG = 1 << 30

# kernel widths (each kernel lays out each width in its own way)
WIDTHS = (64, 128, 256)
# K3 and K4 keep a column's lowest attaining row in 16 bits: query rows
# < 2**16 (longer queries: K4's long form, window_general_long)
K3_MAX_M = 1 << 16
# the pair sweep's long form keys rows t < 2**20 (v1's key, K6's contract)
LONG_MAX_ROWS = 1 << 20
# K3 runs the 64-column windows with rlen <= 32 at 32 columns
NARROW = 32
# K4 runs each width class's short windows, rlen <= K4_SHORT[W], at that
# many columns
K4_SHORT = {64: 32, 128: 96, 256: 192}
# the score table holds score + 16, so that H - 16 is the diagonal operand
TABLE_BIAS = 16
# a code no window holds (codes are 0..4): it scores 0 on every row, which
# K4 reads for a window's rows below its offset
ZERO_CODE = 7


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def width_class(rlens: np.ndarray) -> np.ndarray:
    """Kernel width for each row: the narrowest of WIDTHS >= rlen."""
    rl = np.asarray(rlens)
    if len(rl) and int(rl.max()) > WIDTHS[-1]:
        raise ValueError(f"window length {int(rl.max())} > {WIDTHS[-1]}")
    return np.select([rl <= w for w in WIDTHS[:-1]], WIDTHS[:-1],
                     WIDTHS[-1])


def window_qp(rna: np.ndarray) -> np.ndarray:
    """(q, hi, lo) int32[3, round_up(m + 63, 128)] rows of the window
    pass in the SSW alphabet: s(code, row) = hi if code == q else lo;
    rows >= len(rna) are zero-profile (the striped kernels' phantom
    rows)."""
    m = len(rna)
    mp = _round_up(m + 63, 128)
    q = SSW_ENC[rna].astype(np.int32)
    qp = np.zeros((3, mp), np.int32)
    qp[0, :m] = q
    qp[0, m:] = -1
    qp[1, :m] = np.where(q < 4, 5, -4)
    qp[2, :m] = -4
    return qp


def score_table(qp: torch.Tensor) -> torch.Tensor:
    """The per-row score table int8[Mp, 8] of K3 and K4 from the window
    query rows int32[3, Mp]: byte c of row i is s(c, i) + TABLE_BIAS,
    s(c, i) = hi if c == q else lo for codes 0..6 (the phantom rows are 0
    + TABLE_BIAS), and s(ZERO_CODE, i) = 0 on every row."""
    c = torch.arange(8, dtype=torch.int32, device=qp.device)
    s = torch.where(c[None, :] == qp[0][:, None], qp[1][:, None],
                    qp[2][:, None])
    s[:, ZERO_CODE] = 0
    return (s + TABLE_BIAS).to(torch.int8).contiguous()


def _pair_order(key: torch.Tensor, wide: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    order = torch.argsort(key, stable=True)
    return order.to(torch.int32), (~wide).sum(dtype=torch.int32).reshape(1)


def pair_order(rlens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's row order of a 64-column dispatch: (order int32[rows], the
    windows with rlen <= NARROW first and then the others, each part in
    its own order (stable); the count of the first part int32[1]).  The
    kernel pairs order[2p] and order[2p + 1]; all on the device, with no
    host round trip."""
    wide = rlens > NARROW
    return _pair_order(wide.to(torch.uint8), wide)


def offset_order(rlens: torch.Tensor, offs: torch.Tensor, m: int,
                 short: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's row order: as `pair_order` with the windows with rlen <= short
    first, each part sorted by offset clamped to [0, m] (the kernel starts
    an offset past m at m), so that most of K4's pairs share their start
    row.  The key takes the narrowest integer type that holds it: a radix
    sort's passes grow with its width."""
    wide = rlens > short
    dt = torch.int16 if 2 * m + 1 <= torch.iinfo(torch.int16).max \
        else torch.int32
    key = offs.clamp(0, m).to(dt).add_(wide.to(dt), alpha=m + 1)
    return _pair_order(key, wide)


def both_strands(segs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Flat uint8[2 * S * N]: the segments, then each segment with its
    first lengths[s] bytes reversed (the reversed-transform source)."""
    return torch.cat([segs, reverse_prefix(segs, lengths)]).reshape(-1)


def gather_window_codes(both: torch.Tensor, S: int, N: int,
                        lut_s: torch.Tensor, is_tr: torch.Tensor,
                        seg_idx: torch.Tensor, scan_idx: torch.Tensor,
                        base: torch.Tensor, dirn: torch.Tensor,
                        rlens: torch.Tensor, W: int) -> torch.Tensor:
    """uint8[rows, W] SSW codes: lane l of a row reads the transformed
    segment at base + dirn * l; lanes >= rlen get the pad code 4."""
    li = torch.arange(W, device=both.device)[None, :]
    p = (base.long()[:, None] + dirn.long()[:, None] * li).clamp(0, N - 1)
    sel = is_tr[scan_idx.long()].long()
    byte = both[(sel[:, None] * S + seg_idx.long()[:, None]) * N + p]
    code = lut_s[scan_idx.long()[:, None], byte.long()]
    return torch.where(li < rlens.long()[:, None], code, 4).to(torch.uint8)


def window_pass_ref(codes: torch.Tensor, qp: torch.Tensor,
                    offs: torch.Tensor, terms: torch.Tensor,
                    rlens: torch.Tensor, mreals: torch.Tensor,
                    m: int) -> torch.Tensor:
    """Plain version of both kernels: one exact DP column step at a time
    over all rows (kernels/xla.py:window_pass_xla, which states the
    semantics).  codes uint8[R, W]; qp int32[3, Mp]; per-row int32[R]
    offs, terms, rlens, mreals -> int32[R, 3] (best, end_col, end_row)."""
    R, W = codes.shape
    Mp = qp.shape[1]
    dev = codes.device
    idx = torch.arange(Mp, dtype=torch.int32, device=dev)
    q, hi, lo = qp[0][None, :], qp[1][None, :], qp[2][None, :]
    offs, terms, rlens, mreals = (a.to(torch.int32)
                                  for a in (offs, terms, rlens, mreals))
    smask = idx[None, :] >= offs[:, None]  # zero profile below the offset
    cmask = idx[None, :] < mreals[:, None]  # column max incl. phantom rows
    rmask = (idx[None, :] < m) & smask  # end_row over real rows only
    fbias = idx * GAP_EXTEND
    foff = GAP_OPEN + (idx - 1) * GAP_EXTEND
    h = torch.zeros(R, Mp, dtype=torch.int32, device=dev)
    e = torch.zeros_like(h)
    zero = torch.zeros(R, 1, dtype=torch.int32, device=dev)
    neg = torch.full((R, 1), _NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(R, dtype=torch.int32, device=dev)
    ecol = torch.full((R,), -1, dtype=torch.int32, device=dev)
    erow = torch.full((R,), m - 1, dtype=torch.int32, device=dev)
    act = torch.ones(R, dtype=torch.bool, device=dev)
    cols = codes.to(torch.int32)
    # columns at or past every row's rlen can change nothing
    for k in range(min(W, int(rlens.max()) if R else 0)):
        code = cols[:, k:k + 1]
        s = torch.where(smask, torch.where(code == q, hi, lo), 0)
        e = torch.maximum(e - GAP_EXTEND, h - GAP_OPEN)
        diag = torch.cat([zero, h[:, :-1]], 1)
        tmp = torch.maximum(diag + s, e).clamp_min_(0)
        run = torch.cummax(tmp + fbias, dim=1).values
        f = torch.cat([neg, run[:, :-1]], 1) - foff
        h = torch.maximum(tmp, f)
        cm = torch.where(cmask, h, 0).amax(1)
        rm = torch.where(rmask & (h == cm[:, None]), idx, _BIG).amin(1)
        in_range = k < rlens
        upd = act & (cm > best) & in_range
        best = torch.where(upd, cm, best)
        ecol = torch.where(upd, k, ecol)
        erow = torch.where(upd, rm, erow)
        act = act & ~((cm == terms) & in_range)
    return torch.stack([best, ecol, erow], dim=1)


def _on_card(name: str, codes: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version), True for CUDA ones (the
    kernel); any other device raises."""
    if codes.device.type == "cpu":
        return False
    if codes.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {codes.device}")
    return True


def _run(entry: str, codes: torch.Tensor, *args) -> None:
    """Launch a kernel entry point on codes' device and PyTorch's current
    stream there; raise on its CUDA error code."""
    lib = _build.lib()
    with torch.cuda.device(codes.device):
        err = getattr(lib, entry)(*args, _build.stream_of(codes))
    _build.check(err, entry)


def _check(name: str, codes: torch.Tensor, qp: torch.Tensor, rows: dict):
    W = codes.shape[1]
    if W not in WIDTHS or codes.dtype != torch.uint8 \
            or not codes.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous uint8[rows, W] "
                         f"with W in {WIDTHS}")
    if qp.device != codes.device or qp.dtype != torch.int32 \
            or qp.shape[0] < 3 or not qp.is_contiguous():
        raise ValueError(f"{name}: qp must be contiguous int32[3, Mp] on "
                         f"{codes.device}")
    for key, t in rows.items():
        if t.device != codes.device or t.dtype != torch.int32 \
                or t.shape != (codes.shape[0],) or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous int32[rows]"
                             f" on {codes.device}")


def _check_tab(name: str, tab: torch.Tensor, codes: torch.Tensor,
               rows: int) -> None:
    if tab.device != codes.device or tab.dtype != torch.int8 \
            or tab.dim() != 2 or tab.shape[1] != 8 \
            or tab.shape[0] <= rows or not tab.is_contiguous():
        raise ValueError(f"{name}: tab must be contiguous int8[> {rows}, 8] "
                         f"on {codes.device}")


def window_fwd(codes: torch.Tensor, qp: torch.Tensor, tab: torch.Tensor,
               rlens: torch.Tensor, m: int, m16: int) -> torch.Tensor:
    """K3: ends int32[rows, 3] of the uniform forward pass (off 0, mreal
    m16, no terms).  qp is the window query rows, tab = score_table(qp)
    (the engine keeps both).  CPU tensors take `window_pass_ref` on qp;
    CUDA tensors launch the kernel (counted in `window_fwd.launches`),
    which reads the query through tab and takes m <= K3_MAX_M."""
    rows = codes.shape[0]
    if not _on_card("window_fwd", codes):
        def fill(v):
            return torch.full((rows,), v, dtype=torch.int32)

        return window_pass_ref(codes, qp, fill(0), fill(-1), rlens,
                               fill(m16), m)
    _check("window_fwd", codes, qp, {"rlens": rlens})
    if m > K3_MAX_M:
        raise ValueError(f"window_fwd: m = {m} > {K3_MAX_M} (route to "
                         "window_general)")
    _check_tab("window_fwd", tab, codes, m16)
    order, n_first = pair_order(rlens) if codes.shape[1] == 64 \
        else (None, None)
    out = torch.empty(rows, 3, dtype=torch.int32, device=codes.device)
    _run("fasim_window_fwd", codes, codes.data_ptr(), codes.shape[1],
         tab.data_ptr(), rlens.data_ptr(),
         None if order is None else order.data_ptr(),
         None if n_first is None else n_first.data_ptr(), rows, m, m16,
         out.data_ptr())
    _build.count_launch(window_fwd)
    return out


def _launch_pairs(entry: str, codes: torch.Tensor, offs: torch.Tensor,
                  terms: torch.Tensor, rlens: torch.Tensor,
                  mreals: torch.Tensor, m: int, tab: torch.Tensor,
                  tab_rows: int, wide: bool) -> torch.Tensor:
    """Ends int32[rows, 3] of one checked dispatch on the pair sweep
    (csrc/window_pairs.cuh) through its C entry, K4's fasim_window_gen or
    K6's fasim_window_v1, in its long form when `wide`, in K4's row order
    `offset_order`."""
    rows, W = codes.shape
    order, n_first = offset_order(rlens, offs, m, K4_SHORT[W])
    out = torch.empty(rows, 3, dtype=torch.int32, device=codes.device)
    _run(entry, codes, codes.data_ptr(), W, tab.data_ptr(), tab_rows,
         offs.data_ptr(), mreals.data_ptr(), terms.data_ptr(),
         rlens.data_ptr(), order.data_ptr(), n_first.data_ptr(), rows, m,
         int(wide), out.data_ptr())
    return out


def _general(name: str, codes: torch.Tensor, qp: torch.Tensor,
             offs: torch.Tensor, terms: torch.Tensor, rlens: torch.Tensor,
             mreals: torch.Tensor, m: int, tab: torch.Tensor,
             wide: bool) -> torch.Tensor:
    _check(name, codes, qp,
           {"offs": offs, "terms": terms, "rlens": rlens, "mreals": mreals})
    _check_tab(name, tab, codes, m)
    return _launch_pairs("fasim_window_gen", codes, offs, terms, rlens,
                         mreals, m, tab, tab.shape[0], wide)


def window_general(codes: torch.Tensor, qp: torch.Tensor,
                   offs: torch.Tensor, terms: torch.Tensor,
                   rlens: torch.Tensor, mreals: torch.Tensor, m: int,
                   tab: torch.Tensor) -> torch.Tensor:
    """K4: ends int32[rows, 3] with per-row offs, terms and mreals.  qp is
    the window query rows, tab = score_table(qp) (the engine keeps both).
    Queries longer than K3_MAX_M rows go to `window_general_long`.  Else
    CPU tensors take `window_pass_ref` on qp; CUDA tensors launch the pair
    sweep with 16-bit row keys (counted in `window_general.launches`),
    which reads the query through tab."""
    if m > K3_MAX_M:
        return window_general_long(codes, qp, offs, terms, rlens, mreals, m,
                                   tab)
    if not _on_card("window_general", codes):
        return window_pass_ref(codes, qp, offs, terms, rlens, mreals, m)
    out = _general("window_general", codes, qp, offs, terms, rlens, mreals,
                   m, tab, False)
    _build.count_launch(window_general)
    return out


def window_general_long(codes: torch.Tensor, qp: torch.Tensor,
                        offs: torch.Tensor, terms: torch.Tensor,
                        rlens: torch.Tensor, mreals: torch.Tensor, m: int,
                        tab: torch.Tensor) -> torch.Tensor:
    """K4's long form, the same pass with the row keys folded by chunks of
    65,536 rows (csrc/window_pairs.cuh): what `window_general` runs for m >
    K3_MAX_M; called directly, it runs any m <= LONG_MAX_ROWS.  CPU
    tensors take `window_pass_ref`; CUDA tensors launch the kernel (counted
    in `window_general_long.launches`)."""
    if not _on_card("window_general_long", codes):
        return window_pass_ref(codes, qp, offs, terms, rlens, mreals, m)
    if m > LONG_MAX_ROWS:
        raise ValueError(f"window_general_long: m = {m} > {LONG_MAX_ROWS}")
    out = _general("window_general_long", codes, qp, offs, terms, rlens,
                   mreals, m, tab, True)
    _build.count_launch(window_general_long)
    return out


window_fwd.launches = 0
window_general.launches = 0
window_general_long.launches = 0
