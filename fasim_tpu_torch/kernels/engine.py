"""TorchScanEngine: the port's scan engine.

Counterpart of fasim_tpu/kernels/tpu.py:TpuScanEngine and
kernels/xla.py:XlaScanEngine, with the same methods: the batched driver
and the candidate stage (scan/candidates.py) call `scan_segments*` and
`window_pass*`, the per-segment pipeline (scan/pipeline.py) calls the
engine itself with the `numpy_engine` contract (`__call__`, built on
`colmax_batch` / `max_batch`, which copy `colmax_dev`'s column maxima
to the host; dist.scan_step keeps them on the device).  The engine owns
its tables (the state `state()` / `load_state()` carry):

  * lut_s / lut_t uint8[T, 256], is_tr bool[T]: composed rule-transform
    o encoder LUTs (window gather, v1 scan code rows);
  * lut6_s / lut6_t / istr int32[T, 128]: the same per base class (K1);
  * qp2_ssw / qp2_thresh int32[5, mp2]: the scan query rows (K1);
  * qprops_ssw / qprops_thresh int32[4, mp]: the v1 scan query rows (K5);
  * qwin_fwd / qwin_rev int32[3, mpw]: the window query rows (K3, K4;
    row 0 holds the query codes K6 streams).

Derived from qwin_fwd and qwin_rev whenever they are set, and kept on the
device only: wtab_fwd and wtab_rev int8[mpw, 8], the per-row score tables
(`score_table`) that K3 and K4 read.  Likewise from qp2_ssw and
qp2_thresh: stab_ssw and stab_thresh, K1's score-class tables
(`ScanTable`s of uint8[64 + mp2], from `scan_table`), and stab16_ssw and
stab16_thresh, K7's per-row tables (`Scan16Table`s of uint8[mp2, 8], from
`scan16_table`); and from
qprops_ssw and qprops_thresh: ctab_ssw and ctab_thresh, K5's
(`CodesTable`s of uint8[64 + mp], from `scan_codes_table`).

The engine runs on cuda:0 unless constructed with device="cpu".  On a
CUDA device every device pass is a hand-written kernel; on the CPU the
wrappers take the kernels' plain PyTorch versions.

The switches of fasim_tpu's TpuScanEngine are read where it reads them:
FASIM_SCAN16=1 (at construction) runs the scan passes inside the int16
gate on K7; FASIM_WIN_V1=1 (at setup_windows) runs every window pass on
K6; FASIM_WIN_V3=0 (at setup_windows) sends the uniform forward specs to
K4 instead of K3.  Queries longer than K3_MAX_M rows send them to K4 too
(K3 keeps row indices in 16 bits), whose wrapper runs them, and K6's
wrapper every pass of such a query, on the pair sweep's long form.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import rules
from ..profiling import STAGES
from ..rules import SSW_ENC, THRESH_ENC
from . import _build

from .pack import pack_candidates
from .scan import (N_BASE, PURE, PURE_OR_PAD, Scan16Table, ScanTable,
                   decode_bases, make_lut6, make_qp2, reverse_prefix,
                   scan16_table, scan_colmax, scan_colmax16, scan_table)
from .scan_codes import (CodesTable, apply_byte_break, make_qprops,
                         scan_codes_colmax, scan_codes_table)
from .window import (K3_MAX_M, WIDTHS, both_strands, gather_window_codes,
                     score_table, width_class, window_fwd, window_general,
                     window_qp)
from .window_v1 import query_rows, window_v1

SPEC_KEYS = ("seg_idx", "scan_idx", "base", "dirn", "rlens", "offs",
             "terms", "mreals")

# table -> dtype; shapes are checked against the query and scan count
STATE_DTYPES = {
    "lut_s": np.uint8, "lut_t": np.uint8, "is_tr": np.bool_,
    "lut6_s": np.int32, "lut6_t": np.int32, "istr": np.int32,
    "qp2_ssw": np.int32, "qp2_thresh": np.int32,
    "qprops_ssw": np.int32, "qprops_thresh": np.int32,
    "qwin_fwd": np.int32, "qwin_rev": np.int32,
}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _count_work(name: str, cells: int) -> None:
    """Add the cells a pass asks its kernels to sweep to STAGES' counter
    `name`, or to `<name>_prewarm` on a warm thread (scan/prewarm.py)."""
    STAGES.count(name + "_prewarm" if _build.counted_apart() else name,
                 cells)


class TorchScanEngine:
    """Scan engine on one torch device: "cuda:0" (the default), or "cpu"
    for the plain versions.  `use_v2=False` makes `scan_segments` build
    the code rows on the device and run K5, as fasim_tpu's
    `TpuScanEngine(use_v2=False)` runs its v1 kernel."""

    PACK_K = 384  # > p99 of measured candidate-column counts (270)
    # no per-shape compiles: partial batches are trimmed, not padded
    dynamic_batch = True

    def __init__(self, rna: np.ndarray,
                 device: str | torch.device = "cuda:0", use_v2: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TorchScanEngine: {self.device} requested "
                               "but torch.cuda.is_available() is false; "
                               "pass device='cpu' for the plain versions")
        self.use_v2 = use_v2
        self.m = len(rna)
        self.m16 = _round_up(self.m, 16)
        self.query_pure = bool(PURE[rna].all())
        self._host: dict[str, np.ndarray] = {}
        self._dev: dict[str, torch.Tensor | ScanTable | Scan16Table
                        | CodesTable] = {}
        self._set({"qp2_ssw": make_qp2(rna, SSW_ENC, "ssw"),
                   "qp2_thresh": make_qp2(rna, THRESH_ENC, "thresh"),
                   "qprops_ssw": make_qprops(rna, "ssw"),
                   "qprops_thresh": make_qprops(rna, "thresh")})
        self.scan16 = os.environ.get("FASIM_SCAN16", "0") == "1"
        self.win_v1 = False
        self.win_v3 = True
        # scan/prewarm.py: the (n_pad, batch_pairs) keys warmed on this
        # engine, and the futures of its warm jobs not yet joined
        self.warmed: set[tuple[int, int]] = set()
        self.warm_jobs: list = []

    # -- state ---------------------------------------------------------------

    def _set(self, tables: dict[str, np.ndarray]) -> None:
        for key, arr in tables.items():
            arr = np.ascontiguousarray(arr, STATE_DTYPES[key])
            self._host[key] = arr
            self._dev[key] = torch.from_numpy(arr.copy()).to(self.device)
        for key in ("qwin_fwd", "qwin_rev"):
            if key in tables:
                self._dev[key.replace("qwin", "wtab")] = score_table(
                    self._dev[key])
        for key in ("qp2_ssw", "qp2_thresh"):
            if key in tables:
                thresh = key == "qp2_thresh"
                self._dev[key.replace("qp2", "stab")] = scan_table(
                    self._dev[key], thresh)
                self._dev[key.replace("qp2", "stab16")] = scan16_table(
                    self._dev[key], thresh)
        for alpha in ("ssw", "thresh"):
            if f"qprops_{alpha}" in tables:
                self._dev[f"ctab_{alpha}"] = scan_codes_table(
                    self._dev[f"qprops_{alpha}"], alpha)

    def state(self) -> dict[str, np.ndarray]:
        """Copies of the engine's tables (numpy)."""
        return {k: v.copy() for k, v in self._host.items()}

    def load_state(self, tables: dict[str, np.ndarray]) -> None:
        """Replace tables with ones built elsewhere, e.g. a JAX engine's
        (`XlaScanEngine._scan_luts`, `np.asarray` of a `TpuScanEngine`'s
        `_scan_luts6`, `qp2_*`, `qprops_*`, or `_window_qp` rows).  The
        window tables may also come as the query codes int32[NQ * 128] of
        a TpuScanEngine set up under FASIM_WIN_V1=1
        (`np.asarray(tpu.qwin_fwd)[:, 0, :].reshape(-1)`)."""
        mp2 = _round_up(self.m16 + 64, 128)
        mp = _round_up(self.m16, 128)
        mpw = _round_up(self.m + 63, 128)
        want = {"qp2_ssw": (5, mp2), "qp2_thresh": (5, mp2),
                "qprops_ssw": (4, mp), "qprops_thresh": (4, mp),
                "qwin_fwd": (3, mpw), "qwin_rev": (3, mpw)}
        tables = dict(tables)
        T = None
        for key, arr in tables.items():
            if key not in STATE_DTYPES:
                raise KeyError(f"load_state: unknown table {key!r}")
            arr = np.asarray(arr)
            if key in ("qwin_fwd", "qwin_rev") and arr.shape == (
                    query_rows(self.m),):
                arr = tables[key] = self._window_rows(arr)
            if key in want:
                shape = want[key]
            else:
                T = arr.shape[0] if T is None else T
                shape = {"lut_s": (T, 256), "lut_t": (T, 256),
                         "is_tr": (T,)}.get(key, (T, 128))
            if arr.shape != shape:
                raise ValueError(f"load_state: {key} has shape {arr.shape},"
                                 f" expected {shape}")
        self._set(tables)

    def setup_scans(self, scans: list[dict]) -> None:
        """Composed (rule transform o encoder) tables for the scans."""
        t = len(scans)
        lut_s = np.empty((t, 256), np.uint8)
        lut_t = np.empty((t, 256), np.uint8)
        is_tr = np.zeros(t, np.bool_)
        lut6_s = np.zeros((t, 128), np.int32)
        lut6_t = np.zeros((t, 128), np.int32)
        istr = np.zeros((t, 128), np.int32)
        for k, sc in enumerate(scans):
            rl = rules.transfer_lut(sc["strand"], sc["para"], sc["rule"])
            lut_s[k] = SSW_ENC[rl].astype(np.uint8)
            lut_t[k] = THRESH_ENC[rl].astype(np.uint8)
            is_tr[k] = sc["xform"] == "tr"
            lut6_s[k, :N_BASE] = make_lut6(rl, SSW_ENC)
            lut6_t[k, :N_BASE] = make_lut6(rl, THRESH_ENC)
            istr[k, :] = int(is_tr[k])
        self._set({"lut_s": lut_s, "lut_t": lut_t, "is_tr": is_tr,
                   "lut6_s": lut6_s, "lut6_t": lut6_t, "istr": istr})

    def _window_rows(self, qc: np.ndarray) -> np.ndarray:
        """The v1 query codes (SSW codes, -1 past m) -> window_qp rows."""
        mpw = _round_up(self.m + 63, 128)
        q = np.full(mpw, -1, np.int32)
        q[:len(qc)] = qc
        real = np.arange(mpw) < self.m
        return np.stack([q, np.where(real, np.where(q < 4, 5, -4), 0),
                         np.where(real, -4, 0)]).astype(np.int32)

    def setup_windows(self, rna: np.ndarray) -> None:
        """Window query rows: forward uses the query as is, reverse the
        reversed query (a reverse pass on the query prefix [0..e] is the
        same DP on the reversed query with the leading m-1-e rows' profile
        zeroed — the `offs` of a reverse spec).  Reads FASIM_WIN_V1 and
        FASIM_WIN_V3 (tpu.py:470, 510)."""
        self.win_v1 = os.environ.get("FASIM_WIN_V1", "0") == "1"
        self.win_v3 = os.environ.get("FASIM_WIN_V3", "1") == "1"
        self._set({"qwin_fwd": window_qp(rna),
                   "qwin_rev": window_qp(rna[::-1])})

    # -- scan pass -----------------------------------------------------------

    def _to_dev(self, a, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        np_dt = {torch.uint8: np.uint8, torch.int32: np.int32}[dtype]
        return torch.from_numpy(np.ascontiguousarray(a, np_dt)).to(
            self.device)

    def _segs_pure(self, segs) -> bool:
        if isinstance(segs, torch.Tensor):
            lut = torch.as_tensor(PURE_OR_PAD, device=segs.device)
            return bool(lut[segs.long()].all())
        return bool(PURE_OR_PAD[np.asarray(segs)].all())

    def scan_segments(self, segs, lengths, full_prefix: bool = False,
                      host_segs=None):
        """Scan a batch of raw segments uint8[S, N] (pad byte 0; numpy or
        a tensor — pass the host bytes as host_segs then, for the purity
        test).  Returns tensors on the engine's device: (thresh int32[S, T],
        colmax uint8[S, T, N] clamped at 255).  The kernels' gap is exact
        at any length, so `full_prefix` (fasim_tpu's escalation rerun)
        gives the same thresholds; it only routes, as in fasim_tpu.  K1
        over the raw segments; under FASIM_SCAN16=1 K7 for the passes
        fasim_tpu runs in int16 (tpu.py:371-372, 1113-1125): inside the
        gate, the ssw pass unless fused and full_prefix, the threshold
        pass unless full_prefix.  With use_v2=False K5 over code rows
        built on the device (no int16 variant, as in fasim_tpu)."""
        fused = self.query_pure and self._segs_pure(
            host_segs if host_segs is not None else segs)
        segs_t = self._to_dev(segs, torch.uint8)
        lens_t = self._to_dev(lengths, torch.int32)
        if not self.use_v2:
            return self._scan_segments_v1(segs_t, lens_t, fused)
        bases, bases_rev = decode_bases(segs_t, lens_t)
        d = self._dev
        T = d["istr"].shape[0]
        ok16 = (self.scan16 and T % 2 == 0
                and 5 * min(self.m16, segs.shape[1]) <= 30000)

        def scan(alpha, k7, want_cm=True):
            args = (bases, bases_rev, d[f"lut6_{alpha[0]}"], d["istr"],
                    d[f"qp2_{alpha}"])
            if k7:
                return scan_colmax16(*args, d[f"stab16_{alpha}"], self.m16,
                                     alpha == "thresh", want_cm=want_cm)
            return scan_colmax(*args, d[f"stab_{alpha}"], self.m16,
                               alpha == "thresh", want_cm=want_cm)

        # the cells each pass sweeps: every (segment, transform, query row
        # of m16, column of the padded batch)
        _count_work("scan_cells", (1 if fused else 2) * segs.shape[0] * T
                    * self.m16 * segs.shape[1])
        cm, gm = scan("ssw", ok16 and not (fused and full_prefix))
        if not fused:
            # query U/N or segment bytes outside ACGT: the threshold
            # alphabet scores them differently, so it needs its own pass
            _, gm = scan("thresh", ok16 and not full_prefix, want_cm=False)
        return gm, cm

    def _scan_segments_v1(self, segs: torch.Tensor, lengths: torch.Tensor,
                          fused: bool):
        """tpu.py:_device_scan: the (segment, transform) code rows built
        with the lut_s / lut_t gathers (reversed transforms read the
        reversed segment, pad bytes stay in place and map to N), then K5;
        the threshold is the ssw pass's maximum when fused, else a
        threshold-alphabet pass's."""
        d = self._dev
        S, N = segs.shape
        T = d["lut_s"].shape[0]
        rev = d["is_tr"][None, :, None]
        sel = torch.where(rev, reverse_prefix(segs, lengths)[:, None, :],
                          segs[:, None, :]).long()

        def codes(lut):
            return torch.gather(lut[None].expand(S, T, 256), 2, sel)

        _count_work("scan_cells", (1 if fused else 2) * S * T * self.m16 * N)

        cm = scan_codes_colmax(codes(d["lut_s"]), d["qprops_ssw"],
                               d["ctab_ssw"], self.m16, "ssw")
        if fused:
            thresh = cm.amax(-1)
        else:
            thresh = scan_codes_colmax(codes(d["lut_t"]), d["qprops_thresh"],
                                       d["ctab_thresh"], self.m16,
                                       "thresh").amax(-1)
        return thresh, cm.clamp(max=255).to(torch.uint8)

    def scan_segments_packed(self, segs: np.ndarray, lengths: np.ndarray):
        """scan_segments + device-side candidate packing: (thresh, cm, pos,
        val, cnt, segs_dev), all tensors on the engine's device; segs_dev
        is the uploaded batch, which the window passes reuse.  Only
        (thresh, cm) when N > 32767 (positions are int16)."""
        segs_d = self._to_dev(segs, torch.uint8)
        thresh, cm = self.scan_segments(segs_d, lengths, host_segs=segs)
        if segs.shape[1] > 32767:
            return thresh, cm
        pos, val, cnt = pack_candidates(
            thresh, cm, self._to_dev(lengths, torch.int32), self.PACK_K)
        return thresh, cm, pos, val, cnt, segs_d

    # -- the numpy_engine contract (per-segment pipeline) --------------------

    def colmax_dev(self, codes, which: str) -> torch.Tensor:
        """colmax_batch's column maxima int32[S, T, N], left on the
        engine's device (dist.scan_step)."""
        if which not in ("ssw", "thresh"):
            raise ValueError(f"unknown alphabet {which!r} (ssw|thresh)")
        return scan_codes_colmax(self._to_dev(codes, torch.uint8),
                                 self._dev[f"qprops_{which}"],
                                 self._dev[f"ctab_{which}"], self.m16, which)

    def colmax_batch(self, codes, which: str) -> np.ndarray:
        """Engine codes int[S, T, N] of alphabet `which` (ssw | thresh; a
        ragged batch pads with an out-of-alphabet code) -> exact column
        maxima int32[S, T, N] on the host, through K5."""
        return self.colmax_dev(codes, which).cpu().numpy()

    def max_batch(self, codes, which: str) -> np.ndarray:
        """Engine codes int[S, T, N] -> exact global SW max int32[S, T]
        (the column maxima are exact everywhere: no escalation rerun)."""
        return self.colmax_dev(codes, which).amax(-1).cpu().numpy()

    def __call__(self, rna: np.ndarray, seq2_list: list[np.ndarray]
                 ) -> tuple[np.ndarray, np.ndarray]:
        """numpy_engine contract for one segment's transformed strings:
        (thresh int32[T], byte-broken scan colmax int32[T, N])."""
        seq2 = np.stack(seq2_list)
        thresh = self.max_batch(THRESH_ENC[seq2][None], "thresh")[0]
        scan_cm = self.colmax_batch(SSW_ENC[seq2][None], "ssw")[0]
        return thresh.astype(np.int32), apply_byte_break(scan_cm)

    # -- candidate-window passes --------------------------------------------

    def _check_rows(self, mreals: np.ndarray) -> None:
        rows = self._host["qwin_fwd"].shape[1]
        if len(mreals) and int(np.max(mreals)) > rows:
            raise ValueError(f"mreals up to {int(np.max(mreals))} exceed the "
                             f"{rows} window query rows")

    def window_pass_specs(self, segs, lengths, spec: dict,
                          rev: bool) -> np.ndarray:
        """spec columns (int[rows]) seg_idx, scan_idx, base, dirn (+1 / -1
        window read direction), rlens, offs, terms, mreals -> host int32
        [rows, 3] (best, end_col, end_row).  Windows are gathered on the
        device from the batch's segments and the scan LUTs.  Uniform
        forward specs go to K3 (to K4 under FASIM_WIN_V3=0), everything
        else to K4 (so do they for a query longer than K3_MAX_M); under
        FASIM_WIN_V1=1 every spec goes to K6."""
        rows = len(spec["seg_idx"])
        if rows == 0:
            return np.zeros((0, 3), np.int32)
        cols = {k: np.asarray(spec[k]) for k in SPEC_KEYS}
        uniform = (self.win_v3 and not rev and self.m <= K3_MAX_M
                   and (cols["offs"] == 0).all()
                   and (cols["terms"] == -1).all()
                   and (cols["mreals"] == self.m16).all()
                   and (cols["dirn"] == 1).all())
        self._check_rows(cols["mreals"])
        # the cells the windows need, whatever kernel sweeps them: rows
        # [off, max(mreal, m)) of the query by rlen columns
        _count_work("window_cells", int(
            (cols["rlens"].astype(np.int64)
             * (np.maximum(cols["mreals"], self.m).astype(np.int64)
                - cols["offs"])).sum()))
        segs_t = self._to_dev(segs, torch.uint8)
        S, N = segs_t.shape
        both = both_strands(segs_t, self._to_dev(lengths, torch.int32))
        table = np.stack([cols[k] for k in SPEC_KEYS]).astype(np.int32)
        klass = width_class(cols["rlens"])
        d = self._dev
        qp = d["qwin_rev" if rev else "qwin_fwd"]
        tab = d["wtab_rev" if rev else "wtab_fwd"]
        out = torch.empty(rows, 3, dtype=torch.int32, device=self.device)
        for width in WIDTHS:
            sel = np.flatnonzero(klass == width)
            if not len(sel):
                continue
            part = dict(zip(SPEC_KEYS, self._to_dev(table[:, sel],
                                                    torch.int32)))
            codes = gather_window_codes(
                both, S, N, d["lut_s"], d["is_tr"], part["seg_idx"],
                part["scan_idx"], part["base"], part["dirn"],
                part["rlens"], width)
            if self.win_v1:
                ends = window_v1(codes, self._qcodes(rev), part["offs"],
                                 part["terms"], part["rlens"],
                                 part["mreals"], self.m, tab)
            elif uniform:
                ends = window_fwd(codes, qp, tab, part["rlens"], self.m,
                                  self.m16)
            else:
                ends = window_general(codes, qp, part["offs"],
                                      part["terms"], part["rlens"],
                                      part["mreals"], self.m, tab)
            out[torch.from_numpy(sel).to(self.device)] = ends
        return out.cpu().numpy()

    def _qcodes(self, rev: bool) -> torch.Tensor:
        """The query codes K6 streams: row 0 of the window rows, cut to
        query_rows(m)."""
        return self._dev["qwin_rev" if rev else "qwin_fwd"][
            0, :query_rows(self.m)]

    def window_pass(self, codes: np.ndarray, offs: np.ndarray,
                    terms: np.ndarray, rlens: np.ndarray,
                    mreals: np.ndarray, rev: bool) -> np.ndarray:
        """Window pass over prebuilt codes uint8[rows, W] (SSW alphabet;
        columns >= rlen are never read) with per-row offs / terms / rlens
        / mreals -> host int32[rows, 3] (contract of
        XlaScanEngine.window_pass), per width class through K4; under
        FASIM_WIN_V1=1 through K6."""
        rows, W = codes.shape
        if rows == 0:
            return np.zeros((0, 3), np.int32)
        self._check_rows(np.asarray(mreals))
        meta = np.stack([offs, terms, rlens, mreals]).astype(np.int32)
        klass = width_class(rlens)
        qp = self._dev["qwin_rev" if rev else "qwin_fwd"]
        tab = self._dev["wtab_rev" if rev else "wtab_fwd"]
        out = np.zeros((rows, 3), np.int32)
        for width in WIDTHS:
            sel = np.flatnonzero(klass == width)
            if not len(sel):
                continue
            cp = np.full((len(sel), width), 4, np.uint8)
            take = min(W, width)
            cp[:, :take] = codes[sel, :take]
            cp = self._to_dev(cp, torch.uint8)
            o, t, r, mr = self._to_dev(meta[:, sel], torch.int32)
            if self.win_v1:
                ends = window_v1(cp, self._qcodes(rev), o, t, r, mr, self.m,
                                 tab)
            else:
                ends = window_general(cp, qp, o, t, r, mr, self.m, tab)
            out[sel] = ends.cpu().numpy()
        return out
