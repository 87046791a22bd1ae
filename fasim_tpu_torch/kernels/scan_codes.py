"""K5 scan_codes_colmax: exact column maxima of prebuilt code rows.

Replaces fasim_tpu/kernels/tpu.py:_scan_kernel (the v1 scan kernel,
launched by _kernel_call) for its two callers: the `numpy_engine` contract
of the engine (`colmax_batch` / `max_batch` / `__call__`, which the
per-segment pipeline calls once per segment) and the v1 batched scan
(`_device_scan`, `TorchScanEngine(use_v2=False)`).  The kernel is
csrc/scan_codes.cu (its header says what bounds it on the card and how
the design meets that); `scan_codes_colmax_ref` is its plain PyTorch
version, ported from kernels/xla.py:colmax_xla with the scoring of
tpu.py:_score_col.  `scan_codes_colmax` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors.  The kernel reads the
query through `scan_codes_table` (a `CodesTable`: K1's score-class layout,
scan.py:class_table, of the `qprops` rows' scores, and the alphabet), which
the engine builds once per alphabet, and launches on the plan
`kernel_plan` asks the kernel library for.

The query comes as the JAX engine's `qprops` rows int32[4, round_up(m16,
128)] (`make_qprops`): q (-1 past the query), maska (ssw: q < 4; thresh:
q is T or U), qn (thresh: q is N) and valid (row < m).  The output is
int32 and unclamped: `apply_byte_break` and `max_batch` read values >=
BYTE_SAT.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..config import BYTE_SAT, GAP_EXTEND, GAP_OPEN
from ..rules import SSW_ENC, THRESH_ENC
from . import _build
from .scan import SCAN_CLASSES, class_table

_NEG = -(2 ** 30)

# the out-of-alphabet code a ragged batch pads its code rows with (scores
# like a mismatch; tpu.py:_pad_cols)
PAD_CODE = {"ssw": 5, "thresh": 6}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def make_qprops(rna: np.ndarray, alphabet: str) -> np.ndarray:
    """Query rows int32[4, round_up(m16, 128)] (tpu.py make_qprops)."""
    m = len(rna)
    mp = _round_up(_round_up(m, 16), 128)
    if alphabet == "ssw":
        q = SSW_ENC[rna].astype(np.int32)
        maska, qn = q < 4, np.zeros(m, np.bool_)
    else:
        q = THRESH_ENC[rna].astype(np.int32)
        maska, qn = (q == 3) | (q == 4), q == 5
    props = np.zeros((4, mp), np.int32)
    props[0, :m] = q
    props[0, m:] = -1
    props[1, :m] = maska
    props[2, :m] = qn
    props[3, :m] = 1
    return props


def apply_byte_break(colmax: np.ndarray) -> np.ndarray:
    """Post-op equivalent of the byte kernel's break-at-saturation
    (sswNew.cpp:384-386): zero the first column whose max reaches 251 and
    everything after it.  Works on [..., N] (tpu.py:apply_byte_break)."""
    sat = colmax >= BYTE_SAT
    # first saturated column per row (N if none)
    first = np.where(sat.any(axis=-1), sat.argmax(axis=-1), colmax.shape[-1])
    pos = np.arange(colmax.shape[-1])
    return np.where(pos < first[..., None], colmax, 0).astype(np.int32)


def score_profile(qprops: torch.Tensor, m16: int,
                  alphabet: str) -> torch.Tensor:
    """int32[256, m16]: tpu.py:_score_col's score of every code value
    against every query row < m16."""
    dev = qprops.device
    q, maska, qn, valid = (qprops[r, :m16][None, :] for r in range(4))
    code = torch.arange(256, dtype=torch.int32, device=dev)[:, None]
    eq = code == q
    if alphabet == "ssw":
        s = torch.where(eq & (maska != 0), 5, -4)
    else:
        rtu = (code == 3) | (code == 4)
        eq2 = eq | ((maska != 0) & rtu)
        s = torch.where((qn != 0) | (code == 5), -1,
                        torch.where(eq2, 5, -4))
    return torch.where(valid != 0, s, 0).to(torch.int32)


def scan_codes_colmax_ref(codes: torch.Tensor, qprops: torch.Tensor,
                          m16: int, alphabet: str) -> torch.Tensor:
    """Plain version of the kernel: one exact DP column step at a time
    over all rows, the vertical gap resolved with a cumulative max
    (kernels/xla.py:colmax_xla).  codes uint8[..., N] -> int32[..., N]."""
    lead, N = codes.shape[:-1], codes.shape[-1]
    flat = codes.reshape(-1, N).long()
    rows = flat.shape[0]
    dev = codes.device
    prof = score_profile(qprops, m16, alphabet)
    idx = torch.arange(m16, dtype=torch.int32, device=dev)
    fbias = idx * GAP_EXTEND
    foff = GAP_OPEN + (idx - 1) * GAP_EXTEND
    h = torch.zeros(rows, m16, dtype=torch.int32, device=dev)
    e = torch.zeros_like(h)
    zero = torch.zeros(rows, 1, dtype=torch.int32, device=dev)
    neg = torch.full((rows, 1), _NEG, dtype=torch.int32, device=dev)
    cm = torch.empty(rows, N, dtype=torch.int32, device=dev)
    for j in range(N):
        s = prof[flat[:, j]]
        e = torch.maximum(e - GAP_EXTEND, h - GAP_OPEN)
        diag = torch.cat([zero, h[:, :-1]], 1)
        tmp = torch.maximum(diag + s, e).clamp_min_(0)
        run = torch.cummax(tmp + fbias, dim=1).values
        f = torch.cat([neg, run[:, :-1]], 1) - foff
        h = torch.maximum(tmp, f)
        cm[:, j] = h.amax(1)
    return cm.reshape(*lead, N)


class CodesTable(NamedTuple):
    """K5's query table (`scan_codes_table`): the bytes the kernel reads
    and the alphabet whose scores they hold, which `scan_codes_colmax`
    checks against its own `alphabet`."""
    data: torch.Tensor
    alphabet: str


def scan_codes_table(qprops: torch.Tensor, alphabet: str) -> CodesTable:
    """K5's table, uint8[64 + mp] (scan.py:class_table), from the query
    rows qprops int32[4, mp] of one alphabet: the rows' `score_profile`
    of the codes 0..7.  The kernel reads no other code: as it copies a
    code row into shared memory it folds U (4) to T (3) in the threshold
    alphabet, where they score alike, and every code >= 8 to the
    alphabet's pad code, which scores like it.  The ssw rows hold at most
    6 classes (q = A, C, G, T with maska, the all-mismatch rows, the zero
    rows past m), as do the threshold alphabet's (q = A, C, G, T or U,
    N)."""
    if alphabet not in PAD_CODE:
        raise ValueError(f"scan_codes_table: unknown alphabet {alphabet!r}")
    prof = score_profile(qprops, qprops.shape[1], alphabet)
    return CodesTable(class_table(prof[:SCAN_CLASSES].t(),
                                  "scan_codes_table"), alphabet)


def kernel_plan(rows: int, m16: int) -> tuple[int, int]:
    """(rows a lane, warps a code row's block) of the kernel's launch for
    `rows` code rows at query length m16 (the library's
    fasim_scan_codes_plan; needs the card)."""
    out = (ctypes.c_int * 2)()
    _build.check(_build.lib().fasim_scan_codes_plan(rows, m16, out),
                 "fasim_scan_codes_plan")
    return out[0], out[1]


def blocks_per_sm(plan: tuple[int, int], N: int) -> int:
    """Resident blocks an SM of the launch `plan` with N columns, from the
    CUDA occupancy calculator (needs the card)."""
    n = _build.lib().fasim_scan_codes_blocks_per_sm(*plan, N)
    _build.check(-min(n, 0), "fasim_scan_codes_blocks_per_sm")
    return n


def scan_codes_colmax(codes: torch.Tensor, qprops: torch.Tensor,
                      tab: CodesTable, m16: int, alphabet: str,
                      plan: tuple[int, int] | None = None) -> torch.Tensor:
    """int32[..., N] exact column maxima of the code rows uint8[..., N].
    `tab` is `scan_codes_table(qprops, alphabet)`, which the kernel reads
    in place of qprops; a table of the other alphabet raises ValueError on
    every device.  `plan` (rows a lane, warps), for measuring other plans,
    replaces `kernel_plan`'s.

    CPU tensors take `scan_codes_colmax_ref`; CUDA tensors launch the
    kernel (and count the launch in `scan_codes_colmax.launches`);
    anything else raises."""
    if alphabet not in PAD_CODE:
        raise ValueError(f"scan_codes_colmax: unknown alphabet {alphabet!r}")
    if not isinstance(tab, CodesTable) or tab.alphabet != alphabet:
        raise ValueError("scan_codes_colmax: tab must be the CodesTable of "
                         f"the {alphabet} alphabet")
    if codes.device.type == "cpu":
        return scan_codes_colmax_ref(codes, qprops, m16, alphabet)
    if codes.device.type != "cuda":
        raise ValueError(
            f"scan_codes_colmax: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError("scan_codes_colmax: codes must be a contiguous "
                         "uint8 tensor")
    data = tab.data
    if (data.device != codes.device or data.dtype != torch.uint8
            or not data.is_contiguous() or data.dim() != 1
            or data.shape[0] < 8 * SCAN_CLASSES + m16):
        raise ValueError("scan_codes_colmax: tab must be scan_codes_table's "
                         f"contiguous uint8 bytes on {codes.device}")
    N = codes.shape[-1]
    rows = codes.numel() // N if N else 0
    dev = codes.device
    out = torch.empty(codes.shape, dtype=torch.int32, device=dev)
    if rows == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(dev):
        per_lane, warps = plan or kernel_plan(rows, m16)
        bnd = (torch.empty(rows * 3 * N, dtype=torch.int32, device=dev)
               if lib.fasim_scan_codes_scratch(m16, per_lane, warps)
               else None)
        err = lib.fasim_scan_codes_colmax(
            codes.data_ptr(), rows, N, data.data_ptr(), m16,
            int(alphabet == "thresh"), PAD_CODE[alphabet], per_lane, warps,
            None if bnd is None else bnd.data_ptr(), out.data_ptr(),
            _build.stream_of(codes))
    _build.check(err, "fasim_scan_codes_colmax")
    _build.count_launch(scan_codes_colmax)
    return out


scan_codes_colmax.launches = 0
