"""K1 scan_colmax and K7 scan_colmax16: the scan pass's per-column maxima
and thresholds.

K1 replaces fasim_tpu/kernels/tpu.py:_scan2_kernel and the set-up around
it in _device_scan2 / TpuScanEngine.  The kernel is csrc/scan.cu (its
header says what bounds it on the card and how the design meets that);
it reads the query through `scan_table`, which the engine builds once per
alphabet; `scan_colmax_ref` is its plain PyTorch version, ported from
kernels/xla.py:colmax_xla, and reads the query rows.  K7 replaces the
int16 path of the same Pallas kernel (FASIM_SCAN16=1): the same outputs
from a 16-bit DP, two pairs per 32-bit register, for batches inside the
int16 gate (`in_gate16`).  Its kernel is csrc/scan16.cu, which reads the
query through `scan16_table`, and `scan_colmax16_ref` its plain version,
in torch.int16.  `scan_colmax` / `scan_colmax16` take the plain version
for CPU tensors and launch the kernel for CUDA tensors.

Tables kept in the JAX package's shapes, so an engine's state compares
literally with a `TpuScanEngine`'s:

  * lut6 int32[T, 128]: per transform, the engine code of each base class
    (A C G T U N) in lanes 0..5 (`make_lut6`);
  * istr int32[T, 128]: 1 where the transform reads the reversed segment;
  * qp2 int32[5, mp2]: query rows q, hi, lo, nval (+ the TPU kernel's
    fbias row, unused here) per query position (`make_qp2`).

The kernels' own tables, derived from qp2, each with the alphabet it
scores:

  * K1's `scan_table`, a `ScanTable` of bytes uint8[64 + mp2]: the query
    rows fall into at most SCAN_CLASSES score classes; bytes 0..63 hold
    s + TABLE_BIAS at 8 * code + class, the bytes after them each row's
    class;
  * K7's `scan16_table`, a `Scan16Table` of bytes uint8[mp2, 8]: each
    query row's s + TABLE_BIAS for the engine codes 0..7.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import GAP_EXTEND, GAP_OPEN

from . import _build

_NEG = -(2 ** 30)
SCAN_CLASSES = 8  # score classes of K1's table; class 0 scores 0
TABLE_BIAS = 16  # K1's table holds s + 16 (its cell keeps H - 16)

# base classes of the raw segment bytes: A0 C1 G2 T3 U4, anything else N5
# (tpu.py _BASE6) — transferString translates only uppercase ACGTN, so the
# composition rule LUT o encoder factors through these six classes
BASE6 = np.full(256, 5, np.uint8)
for _i, _c in enumerate(b"ACGTU"):
    BASE6[_c] = _i
N_BASE = 6

# bytes for which the threshold and scan alphabets score identically, so
# one ssw pass also yields the exact threshold ("fused" mode, tpu.py
# _PURE / _PURE_OR_PAD): query ACGT in either case; segment uppercase ACGT
# or the batch pad byte 0
PURE = np.zeros(256, np.bool_)
PURE[list(b"ACGTacgt")] = True
PURE_OR_PAD = np.zeros(256, np.bool_)
PURE_OR_PAD[list(b"ACGT")] = True
PURE_OR_PAD[0] = True


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def make_lut6(rule_lut: np.ndarray, enc: np.ndarray) -> np.ndarray:
    """(6,) engine codes of one transform: base class -> transferString
    target -> engine code (tpu.py:_make_lut6)."""
    chars = np.frombuffer(b"ACGTUN", np.uint8)
    return enc[rule_lut[chars]].astype(np.int32)


def make_qp2(rna: np.ndarray, enc: np.ndarray, alphabet: str) -> np.ndarray:
    """Query rows int32[5, round_up(m16 + 64, 128)] (tpu.py make_qp2):
    q (-1 past the query), hi / lo (the score where the reference code
    equals / differs from q), nval (threshold alphabet: the score of a
    reference N) and the TPU kernel's sentinel fbias row."""
    m = len(rna)
    m16 = _round_up(m, 16)
    mp2 = _round_up(m16 + 64, 128)
    q = enc[rna].astype(np.int32)
    if alphabet == "thresh":
        q = np.where(q == 4, 3, q)  # U scores exactly like T
    qp = np.zeros((5, mp2), np.int32)
    qp[0, :m] = q
    qp[0, m:] = -1
    if alphabet == "ssw":
        qp[1, :m] = np.where(q < 4, 5, -4)
        qp[2, :m] = -4
    else:
        qn = q == 5
        qp[1, :m] = np.where(qn, -1, 5)
        qp[2, :m] = np.where(qn, -1, -4)
        qp[3, :m] = -1
    idx = np.arange(mp2)
    qp[4] = np.where(idx < m16, idx * GAP_EXTEND, _NEG)
    return qp


class ScanTable(NamedTuple):
    """K1's query table (`scan_table`): the bytes the kernel reads and the
    alphabet whose scores they hold, which `scan_colmax` checks against
    its own `thresh_alphabet`."""
    data: torch.Tensor
    thresh_alphabet: bool


def _check_byte(s: torch.Tensor, name: str) -> None:
    if int(s.min()) < -128 - TABLE_BIAS or int(s.max()) > 127 - TABLE_BIAS:
        raise ValueError(f"{name}: a score does not fit the table's byte")


def class_table(s: torch.Tensor, name: str) -> torch.Tensor:
    """The score-class table uint8[64 + rows] of query rows whose scores
    of the codes 0..7 are s int[rows, 8] (K1's and K5's layout, read by
    sw_colmax.cuh:CellI32Dpx).  The distinct score rows are the classes,
    class 0 the all-zero row (the phantom rows' and the kernels' rows
    above row 0); byte 8 * code + k is class k's score of that code plus
    TABLE_BIAS (unused classes score 0), byte 64 + r row r's class.
    ValueError (naming `name`) when the rows have more than SCAN_CLASSES
    classes or a score outside [-144, 111]."""
    _check_byte(s, name)
    rows = torch.cat([torch.zeros_like(s[:1]), s])
    uniq, inv = torch.unique(rows, dim=0, return_inverse=True)
    n = uniq.shape[0]
    if n > SCAN_CLASSES:
        raise ValueError(f"{name}: {n} score classes (the zero row "
                         f"included), the kernel takes {SCAN_CLASSES}")
    # swap the zero row's class with class 0 (a swap is its own inverse)
    perm = torch.arange(n, device=s.device)
    zero = int(inv[0])
    perm[0], perm[zero] = zero, 0
    scores = torch.zeros(SCAN_CLASSES, 8, dtype=torch.int32,
                         device=s.device)
    scores[:n] = uniq[perm]
    tab = (scores.t() + TABLE_BIAS).reshape(-1)
    return torch.cat([tab, perm[inv[1:]].to(torch.int32)]).to(
        torch.uint8).contiguous()


def _row_scores(qp: torch.Tensor, thresh_alphabet: bool) -> torch.Tensor:
    """int32[mp2, 8]: each query row's score of the engine codes 0..7, as
    scan_colmax_ref reads it from qp2 int32[>=4, mp2]."""
    c = torch.arange(8, dtype=torch.int32, device=qp.device)[None, :]
    s = torch.where(c == qp[0][:, None], qp[1][:, None], qp[2][:, None])
    if thresh_alphabet:
        s = torch.where(c == 5, qp[3][:, None], s)
    return s


def scan_table(qp: torch.Tensor, thresh_alphabet: bool) -> ScanTable:
    """K1's table, uint8[64 + mp2] (`class_table`), from the query rows
    qp2 int32[>=4, mp2] of one alphabet.  ValueError when the rows have
    more than SCAN_CLASSES classes (make_qp2 builds at most 6) or a score
    outside [-144, 111]."""
    return ScanTable(class_table(_row_scores(qp, thresh_alphabet),
                                 "scan_table"), thresh_alphabet)


class Scan16Table(NamedTuple):
    """K7's query table (`scan16_table`): the bytes the kernel reads and
    the alphabet whose scores they hold, which `scan_colmax16` checks
    against its own `thresh_alphabet`."""
    data: torch.Tensor
    thresh_alphabet: bool


def scan16_table(qp: torch.Tensor, thresh_alphabet: bool) -> Scan16Table:
    """K7's table, uint8[mp2, 8], from the query rows qp2 int32[>=4, mp2]
    of one alphabet: byte (r, code) is row r's score of the engine code
    plus TABLE_BIAS, the byte that sw_colmax.cuh:CellS16x2T's prmt picks
    and sign-extends (the threshold alphabet's code 5 scores nval; the
    phantom rows past the query score 0, so their bytes are all 16).
    ValueError for a score outside [-144, 111]."""
    s = _row_scores(qp, thresh_alphabet)
    _check_byte(s, "scan16_table")
    return Scan16Table((s + TABLE_BIAS).to(torch.uint8).contiguous(),
                       thresh_alphabet)


def reverse_prefix(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x[S, N] with each row's first lengths[s] entries reversed and the
    pad kept in place (the reversed-transform source, tpu.py
    _device_scan)."""
    N = x.shape[1]
    pos = torch.arange(N, device=x.device)
    lens = lengths.long()[:, None]
    ridx = torch.where(pos[None, :] < lens, lens - 1 - pos[None, :],
                       pos[None, :])
    return torch.gather(x, 1, ridx)


def decode_bases(segs: torch.Tensor, lengths: torch.Tensor):
    """Raw segment bytes uint8[S, N] -> base classes (bases, bases_rev),
    both uint8[S, N]; bases_rev reverses each segment's first lengths[s]
    bytes and keeps the pad in place (tpu.py _device_scan2)."""
    lut = torch.as_tensor(BASE6, device=segs.device)
    bases = lut[segs.long()]
    return bases, reverse_prefix(bases, lengths)


def in_gate16(T: int, m16: int, N: int) -> bool:
    """K7's gate (tpu.py:371-372): an even transform count, since pairs
    2k and 2k + 1 share a register, and every H within int16 with the
    decay margin, H <= 5 * min(m16, N) <= 30000."""
    return T % 2 == 0 and 5 * min(m16, N) <= 30000


def _check_gate16(T: int, m16: int, N: int) -> None:
    if not in_gate16(T, m16, N):
        raise ValueError(f"scan_colmax16: T={T}, m16={m16}, N={N} is "
                         "outside the int16 gate")


def _pair_codes(bases, bases_rev, lut6, istr) -> torch.Tensor:
    """Engine codes int64[S * T, N] of every (segment, transform) pair."""
    S, N = bases.shape
    T = lut6.shape[0]
    rev = istr[:, 0].ne(0)[None, :, None]
    sel = torch.where(rev, bases_rev[:, None, :], bases[:, None, :])
    return torch.gather(lut6[:, :N_BASE].unsqueeze(0).expand(S, T, N_BASE),
                        2, sel.long()).reshape(S * T, N)


def scan_colmax_ref(bases: torch.Tensor, bases_rev: torch.Tensor,
                    lut6: torch.Tensor, istr: torch.Tensor, qp: torch.Tensor,
                    m16: int, thresh_alphabet: bool):
    """Plain version of the kernel: one exact DP column step at a time
    over every (segment, transform) row, the vertical gap resolved with
    a cumulative max (kernels/xla.py:colmax_xla).  Returns (colmax uint8
    [S, T, N] clamped at 255, per-pair maximum int32[S, T])."""
    S, N = bases.shape
    T = lut6.shape[0]
    dev = bases.device
    codes = _pair_codes(bases, bases_rev, lut6, istr)
    q, hi, lo, nval = (qp[r, :m16] for r in range(4))
    idx = torch.arange(m16, dtype=torch.int32, device=dev)
    fbias = idx * GAP_EXTEND
    foff = GAP_OPEN + (idx - 1) * GAP_EXTEND
    rows = S * T
    h = torch.zeros(rows, m16, dtype=torch.int32, device=dev)
    e = torch.zeros_like(h)
    zero = torch.zeros(rows, 1, dtype=torch.int32, device=dev)
    neg = torch.full((rows, 1), _NEG, dtype=torch.int32, device=dev)
    cm = torch.empty(rows, N, dtype=torch.int32, device=dev)
    for j in range(N):
        c = codes[:, j:j + 1]
        s = torch.where(c == q, hi, lo)
        if thresh_alphabet:
            s = torch.where(c == 5, nval, s)
        e = torch.maximum(e - GAP_EXTEND, h - GAP_OPEN)
        diag = torch.cat([zero, h[:, :-1]], 1)
        tmp = torch.maximum(diag + s, e).clamp_min_(0)
        run = torch.cummax(tmp + fbias, dim=1).values
        f = torch.cat([neg, run[:, :-1]], 1) - foff
        h = torch.maximum(tmp, f)
        cm[:, j] = h.amax(1)
    cm = cm.view(S, T, N)
    return cm.clamp(max=255).to(torch.uint8), cm.amax(2)


def scan_colmax16_ref(bases: torch.Tensor, bases_rev: torch.Tensor,
                      lut6: torch.Tensor, istr: torch.Tensor,
                      qp: torch.Tensor, m16: int, thresh_alphabet: bool):
    """Plain version of K7, its arithmetic in torch.int16: one DP column
    step at a time, the vertical gap resolved by a decaying prefix max
    run(i) = max over d >= 0 of tmp(i - d) - 4d (the int16 form of
    tpu.py:_dp_col2, over the whole query), whose values stay within
    [-16384, 30000].  Offsets past 8192 rows are not needed: their decay
    exceeds any H under the gate.  Refuses batches outside `in_gate16`.
    Returns scan_colmax_ref's (colmax uint8[S, T, N], max int32[S, T])."""
    S, N = bases.shape
    T = lut6.shape[0]
    _check_gate16(T, m16, N)
    dev = bases.device
    i16 = torch.int16
    codes = _pair_codes(bases, bases_rev, lut6, istr)
    q, hi, lo, nval = (qp[r, :m16].to(i16) for r in range(4))
    rows = S * T
    h = torch.zeros(rows, m16, dtype=i16, device=dev)
    e = torch.zeros_like(h)
    zero = torch.zeros(rows, 1, dtype=i16, device=dev)
    cm = torch.empty(rows, N, dtype=i16, device=dev)
    for j in range(N):
        c = codes[:, j:j + 1]
        s = torch.where(c == q, hi, lo)
        if thresh_alphabet:
            s = torch.where(c == 5, nval, s)
        e = torch.maximum(e - GAP_EXTEND, h - GAP_OPEN)
        diag = torch.cat([zero, h[:, :-1]], 1)
        tmp = torch.maximum(diag + s, e).clamp_min_(0)
        run = tmp
        k = 1
        while k < m16 and k <= 4096:
            shifted = torch.cat([torch.zeros_like(run[:, :k]), run[:, :-k]],
                                1)
            run = torch.maximum(run, shifted - k * GAP_EXTEND)
            k *= 2
        f = torch.cat([zero, run[:, :-1]], 1) - GAP_OPEN
        h = torch.maximum(tmp, f)
        cm[:, j] = h.amax(1)
    cm = cm.view(S, T, N)
    return (cm.clamp(max=255).to(torch.uint8),
            cm.amax(2).to(torch.int32))


def _check_inputs(name: str, bases, bases_rev, lut6, istr, qp, m16: int):
    if bases.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {bases.device}")
    N = bases.shape[1]
    T = lut6.shape[0]
    for arg, t, dt in (("bases", bases, torch.uint8),
                       ("bases_rev", bases_rev, torch.uint8),
                       ("lut6", lut6, torch.int32),
                       ("istr", istr, torch.int32),
                       ("qp", qp, torch.int32)):
        if t.device != bases.device or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous "
                             f"{dt} tensor on {bases.device}")
    if (bases_rev.shape != bases.shape or lut6.shape[1] < N_BASE
            or istr.shape[0] != T or qp.shape[0] < 4 or qp.shape[1] < m16):
        raise ValueError(f"{name}: inconsistent shapes")


def _launch(wrapper, entry: str, pairs_per_warp: int, bases, bases_rev,
            lut6, istr, tab: torch.Tensor, m16: int, want_cm: bool):
    """Launch `entry` on checked CUDA inputs and the kernel's table bytes
    `tab`, and count the launch on `wrapper`: (colmax or None, per-pair
    max)."""
    S, N = bases.shape
    T = lut6.shape[0]
    lib = _build.lib()
    dev = bases.device
    gm = torch.empty(S, T, dtype=torch.int32, device=dev)
    cm = (torch.empty(S, T, N, dtype=torch.uint8, device=dev) if want_cm
          else None)
    # one strip's bottom row (H, F, column max) per warp
    bnd = (torch.empty(S * T // pairs_per_warp * 3 * N, dtype=torch.int32,
                       device=dev)
           if m16 > lib.fasim_scan_strip_rows() else None)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            bases.data_ptr(), bases_rev.data_ptr(), lut6.data_ptr(),
            lut6.stride(0), istr.data_ptr(), istr.stride(0), tab.data_ptr(),
            S, T, N, m16, None if bnd is None else bnd.data_ptr(),
            None if cm is None else cm.data_ptr(), gm.data_ptr(),
            _build.stream_of(bases))
    _build.check(err, entry)
    _build.count_launch(wrapper)
    return cm, gm


def scan_colmax(bases: torch.Tensor, bases_rev: torch.Tensor,
                lut6: torch.Tensor, istr: torch.Tensor, qp: torch.Tensor,
                tab: ScanTable, m16: int, thresh_alphabet: bool,
                want_cm: bool = True):
    """K1: (colmax uint8[S, T, N] or None, per-pair max int32[S, T]).
    `tab` is `scan_table(qp, thresh_alphabet)`, which the kernel reads in
    place of qp (lut6's engine codes must be < 8); a table of the other
    alphabet raises ValueError on every device.

    CPU tensors take `scan_colmax_ref`; CUDA tensors launch the kernel
    (and count the launch in `scan_colmax.launches`); anything else
    raises."""
    if not isinstance(tab, ScanTable) \
            or tab.thresh_alphabet != thresh_alphabet:
        raise ValueError("scan_colmax: tab must be the ScanTable of the "
                         f"{'threshold' if thresh_alphabet else 'ssw'} "
                         "alphabet")
    if bases.device.type == "cpu":
        cm, gm = scan_colmax_ref(bases, bases_rev, lut6, istr, qp, m16,
                                 thresh_alphabet)
        return (cm if want_cm else None), gm
    _check_inputs("scan_colmax", bases, bases_rev, lut6, istr, qp, m16)
    data = tab.data
    if (data.device != bases.device or data.dtype != torch.uint8
            or not data.is_contiguous() or data.dim() != 1
            or data.shape[0] < 8 * SCAN_CLASSES + m16):
        raise ValueError("scan_colmax: tab must be scan_table's contiguous "
                         f"uint8 bytes on {bases.device}")
    return _launch(scan_colmax, "fasim_scan_colmax", 1, bases, bases_rev,
                   lut6, istr, data, m16, want_cm)


def scan_colmax16(bases: torch.Tensor, bases_rev: torch.Tensor,
                  lut6: torch.Tensor, istr: torch.Tensor, qp: torch.Tensor,
                  tab: Scan16Table, m16: int, thresh_alphabet: bool,
                  want_cm: bool = True):
    """K7: scan_colmax's outputs from the 16-bit DP, for a batch inside
    `in_gate16` (else ValueError).  `tab` is `scan16_table(qp,
    thresh_alphabet)`, which the kernel reads in place of qp (lut6's
    engine codes must be < 8); a table of the other alphabet raises
    ValueError on every device.

    CPU tensors take `scan_colmax16_ref`; CUDA tensors launch the kernel
    (counted in `scan_colmax16.launches`); anything else raises."""
    if not isinstance(tab, Scan16Table) \
            or tab.thresh_alphabet != thresh_alphabet:
        raise ValueError("scan_colmax16: tab must be the Scan16Table of the "
                         f"{'threshold' if thresh_alphabet else 'ssw'} "
                         "alphabet")
    if bases.device.type == "cpu":
        cm, gm = scan_colmax16_ref(bases, bases_rev, lut6, istr, qp, m16,
                                   thresh_alphabet)
        return (cm if want_cm else None), gm
    _check_inputs("scan_colmax16", bases, bases_rev, lut6, istr, qp, m16)
    _check_gate16(lut6.shape[0], m16, bases.shape[1])
    data = tab.data
    if (data.device != bases.device or data.dtype != torch.uint8
            or not data.is_contiguous() or data.dim() != 2
            or data.shape[1] != 8 or data.shape[0] < m16
            or data.data_ptr() % 8 != 0):
        raise ValueError("scan_colmax16: tab must be scan16_table's "
                         f"contiguous uint8 rows on {bases.device}")
    return _launch(scan_colmax16, "fasim_scan_colmax16", 2, bases,
                   bases_rev, lut6, istr, data, m16, want_cm)


def kernel_rows(m16: int) -> int:
    """Rows a lane of the K1 and K7 kernels launched at query length m16:
    their template argument, sw_colmax.cuh:sweep_rows (needs the card)."""
    return _build.lib().fasim_scan_rows(m16)


def blocks_per_sm(m16: int, N: int) -> int:
    """K1's resident one-warp blocks an SM at query length m16 and N
    segment columns, from the CUDA occupancy calculator (needs the
    card)."""
    n = _build.lib().fasim_scan_blocks_per_sm(m16, N)
    _build.check(-min(n, 0), "fasim_scan_blocks_per_sm")
    return n


def scan16_blocks_per_sm(m16: int, N: int) -> int:
    """K7's resident one-warp blocks an SM, as blocks_per_sm (needs the
    card)."""
    n = _build.lib().fasim_scan16_blocks_per_sm(m16, N)
    _build.check(-min(n, 0), "fasim_scan16_blocks_per_sm")
    return n


scan_colmax.launches = 0
scan_colmax16.launches = 0
