"""K8 sim_forward: the device forward scan of the exact SIM engine (-F).

Replaces fasim_tpu/kernels/sim_dev.py:_sim_forward (XLA, not Pallas) and
ports its host glue `sim_forward_cells`.  Under FASIM_SIM_DEVICE=1 (CLI:
`--tpu-sim-device true`) the `-F` host stage (scan/batched.py) runs the
forward scan of sim.h:511-567 here, picks the qualifying cells (score >
min_score, the reference's 10x-vs-raw threshold quirk, sim.h:562) out on
the device, and the host replays them through its node list
(native.sim_scan_replay), which keeps the K=50 node list, the traceback
and the rectangle recomputation.  The output is byte-identical to the
host SIM's.

Per cell the forward scan keeps the lexicographic maximum of (score,
packed start t = si * (N + 2) + sj), the ORDER tie-break of sim.h:487-498
(t is monotone in (si, sj)).  The packing needs (m + 1)(N + 2) < 2^31:
`sim_device_ok`; past it the host SIM runs (routing by shape).

`sim_forward` launches csrc/sim_forward.cu for CUDA tensors (its header
says what bounds it on the card and how the design meets that; it keeps
each (score, t) as one int64 key) and takes `sim_forward_ref`, the plain
PyTorch version, for CPU tensors.  The plain version is a port of the JAX
column scan: query rows on lanes, the lex pair (score, t) compared
field by field, the vertical gap as a masked lex prefix, so that it does
not share the kernel's key arithmetic and the two check each other.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from . import _build

_Q = 120  # gap open, 10x units (sim.h:470-475 with LongTarget's args)
_R = 40   # gap extend
_NEG = -(2 ** 29)

# char -> ACGT code (0-3), 4 = everything else (V rows are zero there)
_SIM_ENC = np.full(256, 4, np.int32)
for _i, _c in enumerate(b"ACGT"):
    _SIM_ENC[_c] = _i

# query rows a lane the kernel has an instantiation for
KERNEL_ROWS = (1, 2, 4, 8, 16)
# shared memory a block can use on an H100 (227 KB)
SMEM_LIMIT = 232_448
# the columns of the row above a strip takes at a time (csrc kBatch)
BATCH_COLS = 8


def sim_device_ok(m: int, n: int) -> bool:
    """Whether a query of m rows against n reference columns fits the
    packed start t = si * (n + 2) + sj < 2^31 (fasim_tpu/scan/batched.py:
    171-172); past it the host SIM runs."""
    return (m + 1) * (n + 2) < 2 ** 31


def _round_up(x: int, k: int) -> int:
    return (x + k - 1) // k * k


def _strips(m: int, rows: int) -> int:
    """K8's strips of 32 lanes x `rows` query rows for m rows."""
    return (m + 32 * rows - 1) // (32 * rows)


def drain_cols(rows: int) -> int:
    """Columns a warp drains from its cell ring at a time (csrc Ring::
    kDrain); the ring holds 32 more."""
    return 16 if rows >= 16 else 32


def smem_bytes(rows: int) -> int:
    """Dynamic shared memory of a K8 block, one warp (csrc smem_bytes, and
    fasim_sim_forward_smem, which chip_smoke.py phase 7 holds it against):
    its cs and ct planes of 32 rows x (drain + 32) columns."""
    return 32 * rows * (drain_cols(rows) + 32) * 8


class Launch(NamedTuple):
    """A K8 launch: strips (one-warp blocks) a pair, dynamic shared memory
    a block."""
    strips: int
    smem: int


def launch_shape(m: int, n: int, rows: int) -> Launch:
    """The launch csrc/sim_forward.cu takes for m query rows and n
    columns; raises ValueError on what its C entry refuses: rows not an
    instantiation, a packed start past sim_device_ok, m or n < 1."""
    if rows not in KERNEL_ROWS:
        raise ValueError(f"sim_forward: rows {rows} not in {KERNEL_ROWS}")
    if m < 1 or n < 1:
        raise ValueError(f"sim_forward: no launch for m={m}, N={n}")
    if not sim_device_ok(m, n):
        raise ValueError(f"sim_forward: (m + 1)(N + 2) >= 2^31 at m={m}, "
                         f"N={n}: the packed start does not fit")
    return Launch(_strips(m, rows), smem_bytes(rows))


def chain_steps(m: int, n: int, rows: int, lag: int | None = None) -> int:
    """Steps of a pair's longest chain in K8: the last strip's n + 31
    steps after `lag` steps a strip above it.  By default the schedule's
    own lag, if every hand-off took no time: lane 31 hands column j down
    at step j + 30, and a strip takes the row above BATCH_COLS columns at
    a time, so it runs min(BATCH_COLS, n) + 31 steps behind the strip
    above (tests/test_torch_sim_dev_k8.py simulates the schedule)."""
    if lag is None:
        lag = min(BATCH_COLS, n) + 31
    return n + 31 + lag * (_strips(m, rows) - 1)


# K8's time, fitted to an H100's times of every instantiation at h19_F's
# group and NEAT1 length (chip_smoke.py phase 7; PERF.md §6): chain_steps
# with a lag of STEP_LAG steps a strip (the hand-off's time beyond the
# schedule's) times a + b * rows ns a step
STEP_LAG = 45
STEP_NS = (242.2, 34.0)


def kernel_rows(m: int, n: int, t: int = 1, sms: int = 132) -> int:
    """Query rows a lane for K8 at m query rows, n columns and t pairs:
    the least modelled time, chain_steps(m, n, rows, STEP_LAG) times the
    cost of a step STEP_NS, times the blocks an SM past one (t pairs'
    blocks over `sms` SMs, as many a SM as its shared memory holds)."""
    a, b = STEP_NS

    def cost(r: int) -> float:
        shape = launch_shape(m, n, r)
        per_sm = max(1, SMEM_LIMIT // shape.smem)
        return (chain_steps(m, n, r, STEP_LAG) * (a + b * r)
                * max(1.0, t * shape.strips / (sms * per_sm)))

    return min(KERNEL_ROWS, key=lambda r: (cost(r), r))


def _lex_max(s1, t1, s2, t2):
    """Elementwise lexicographic max on (score, packed start)."""
    take2 = (s2 > s1) | ((s2 == s1) & (t2 > t1))
    return torch.where(take2, s2, s1), torch.where(take2, t2, t1)


def _shift(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """x moved k lanes up the last axis (lane l takes lane l - k); the
    first k lanes take `fill`."""
    return torch.cat([x.new_full((x.shape[0], k), fill), x[:, :-k]], dim=1)


def sim_forward_ref(q: torch.Tensor, refs: torch.Tensor, m: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8 (fasim_tpu/kernels/sim_dev.py:
    _sim_forward, column by column).  q int32[Mp >= m] query codes (pad 9),
    refs int32[T, N] reference codes; returns (cs, ct) int32[T, m, N]."""
    T, N = refs.shape
    mp = q.shape[0]
    dev = refs.device
    i32 = torch.int32
    lane = torch.arange(mp, dtype=i32, device=dev)[None, :]  # i - 1
    q2 = q.to(i32)[None, :]
    qlt4 = q2 < 4
    rowbase = (lane + 1) * (N + 2)                          # start (i, 0)
    bias = lane * _R
    steps = []
    k = 1
    while k < mp:
        steps.append(k)
        k *= 2
    cs = torch.zeros((T, mp), dtype=i32, device=dev)
    ct = rowbase.expand(T, mp).clone()
    fs = torch.full((T, mp), -_Q, dtype=i32, device=dev)
    ft = ct.clone()
    refs = refs.to(i32)
    out_s, out_t = [], []
    for j in range(N):
        code = refs[:, j:j + 1]
        s = torch.where((code == q2) & qlt4, 50,
                        torch.where(qlt4 & (code < 4), -40, 0)).to(i32)
        # F: horizontal gap, carried per lane
        fs, ft = _lex_max(fs - _R, ft, cs - (_Q + _R), ct)
        # diagonal from the previous column, row-0 boundary (0, j - 1)
        diag_s = _shift(cs, 1, 0)
        diag_t = _shift(ct, 1, j)
        base_s = diag_s + s
        restart = base_s <= 0
        pre_s = torch.where(restart, 0, base_s).to(i32)
        pre_t = torch.where(restart, rowbase + (j + 1), diag_t)
        pre_s, pre_t = _lex_max(pre_s, pre_t, fs, ft)
        # D: vertical gap, masked lex prefix over biased C_pre
        bs, bt = pre_s + bias, pre_t
        for k in steps:
            bs, bt = _lex_max(bs, bt, _shift(bs, k, _NEG), _shift(bt, k, 0))
        ds = _shift(bs, 1, _NEG) - (_Q + bias)
        dt = _shift(bt, 1, 0)
        cs, ct = _lex_max(pre_s, pre_t, ds, dt)
        out_s.append(cs[:, :m])
        out_t.append(ct[:, :m])
    if not out_s:
        empty = torch.empty((T, m, 0), dtype=i32, device=dev)
        return empty, empty.clone()
    return torch.stack(out_s, dim=2), torch.stack(out_t, dim=2)


def sim_forward(q: torch.Tensor, refs: torch.Tensor, m: int,
                rows: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cs, ct) int32[T, m, N]: every cell's final (score, packed start)
    of the SIM forward scan, query rows first (the scan order).  q
    int32[Mp >= m] query codes, refs int32[T, N] reference codes (0-3
    ACGT, anything else scores 0).  `rows` (query rows a lane, one of
    KERNEL_ROWS), for measuring others, replaces `kernel_rows`'s.

    CPU tensors take `sim_forward_ref`; CUDA tensors launch the kernel (and
    count the launch in `sim_forward.launches`); anything else raises.  A
    shape past `sim_device_ok` raises ValueError on every device."""
    if refs.dim() != 2 or q.dim() != 1 or q.shape[0] < m:
        raise ValueError("sim_forward: q must be [Mp >= m] and refs [T, N]")
    T, N = refs.shape
    if not sim_device_ok(m, N):
        raise ValueError(f"sim_forward: (m + 1)(N + 2) >= 2^31 at m={m}, "
                         f"N={N}: the packed start does not fit")
    if refs.device.type == "cpu":
        return sim_forward_ref(q, refs, m)
    if refs.device.type != "cuda":
        raise ValueError(f"sim_forward: unsupported device {refs.device}")
    for name, t in (("q", q), ("refs", refs)):
        if (t.device != refs.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"sim_forward: {name} must be a contiguous "
                             f"int32 tensor on {refs.device}")
    rows = rows or kernel_rows(
        m, N, T, torch.cuda.get_device_properties(
            refs.device).multi_processor_count)
    dev = refs.device
    cs = torch.empty((T, m, N), dtype=torch.int32, device=dev)
    ct = torch.empty_like(cs)
    if cs.numel() == 0:
        return cs, ct
    shape = launch_shape(m, N, rows)
    lib = _build.lib()
    with torch.cuda.device(dev):
        # each strip's bottom row, as 16-byte entries every word of which
        # reads 0xffffffff until written; the ticket counter
        bnd = torch.full((T * shape.strips * N * 4,), -1, dtype=torch.int32,
                         device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.fasim_sim_forward(
            q.data_ptr(), m, refs.data_ptr(), N, T, rows, shape.strips,
            bnd.data_ptr(), ticket.data_ptr(), cs.data_ptr(), ct.data_ptr(),
            _build.stream_of(refs))
    _build.check(err, "fasim_sim_forward")
    _build.count_launch(sim_forward)
    return cs, ct


sim_forward.launches = 0


def encode(rna: np.ndarray, refs_u8: list[np.ndarray]
           ) -> tuple[np.ndarray, np.ndarray]:
    """The forward scan's inputs: query codes int32[round_up(m, 8)] (pad
    9) and reference codes int32[T, N]."""
    m = len(rna)
    q = np.full(_round_up(m, 8), 9, np.int32)
    q[:m] = _SIM_ENC[rna]
    refs = np.stack([_SIM_ENC[r] for r in refs_u8]).astype(np.int32)
    return q, refs


# the pieces of sim_forward_cells that `times` splits it into
CELLS_PIECES = ("encode, copy in", "K8", "compare, count, nonzero",
                "gathers, stack", "copy to host", "numpy split")


@contextlib.contextmanager
def _piece(times: dict | None, name: str, dev: torch.device):
    """Time the block as piece `name` into times[name], a list of (device
    ms by CUDA events or None on the CPU, host ms): each piece starts and
    ends synchronized.  No-op when times is None."""
    if times is None:
        yield
        return
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    yield
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
    host = (time.perf_counter() - t0) * 1e3
    times.setdefault(name, []).append(
        (start.elapsed_time(end) if cuda else None, host))


def sim_forward_cells(rna: np.ndarray, refs_u8: list[np.ndarray],
                      min_scores: list[int], device,
                      times: dict | None = None) -> list[np.ndarray]:
    """Forward-scan one query against T transformed refs on `device` (a
    CUDA device launches K8; the CPU runs the plain version) and pick out
    the qualifying cells there; returns per pair the cell stream int32[n,
    5] = (c, ci, cj, i, j) in scan order (i-major), ready for
    native.sim_scan_replay.  Only those cells leave the device.  The
    caller guarantees sim_device_ok(len(rna), len(refs_u8[0]))
    (fasim_tpu/kernels/sim_dev.py:sim_forward_cells).  A dict `times`
    gets each of CELLS_PIECES' times appended (`_piece`; the pieces are
    then synchronized, so measure with it, never run the driver with
    it)."""
    m = len(rna)
    n = len(refs_u8[0])
    T = len(refs_u8)
    dev = torch.device(device)
    with _piece(times, "encode, copy in", dev):
        q, refs = encode(rna, refs_u8)
        qd = torch.from_numpy(q).to(dev)
        rd = torch.from_numpy(refs).to(dev)
    with _piece(times, "K8", dev):
        cs, ct = sim_forward(qd, rd, m)
    with _piece(times, "compare, count, nonzero", dev):
        mins = torch.tensor(min_scores, dtype=torch.int32, device=dev)
        hit = cs > mins[:, None, None]
        counts = hit.view(T, -1).sum(dim=1).tolist()
        flat = torch.nonzero(hit.view(-1)).squeeze(1)  # (t, i, j) row-major
    with _piece(times, "gathers, stack", dev):
        c = cs.view(-1)[flat]
        st = ct.view(-1)[flat]
        ci = torch.div(st, n + 2, rounding_mode="floor")
        cj = st - ci * (n + 2)
        rest = flat % (m * n)
        cells = torch.stack([c, ci, cj, (rest // n + 1).to(torch.int32),
                             (rest % n + 1).to(torch.int32)], dim=1)
    with _piece(times, "copy to host", dev):
        cells = cells.cpu().numpy()
    with _piece(times, "numpy split", dev):
        out = [np.ascontiguousarray(x) for x in
               np.split(cells, np.cumsum(counts)[:-1])]
    return out
