"""K7's 16-bit cell (csrc/sw_colmax.cuh:CellS16x2T, csrc/scan16.cu) on the
CPU: its per-row table (`scan16_table`) against the plain scores, the
wrapper's refusal of the other alphabet's table, and a bit-level numpy
model of the kernel against `scan_colmax16_ref` and the JAX package's
int16 Pallas path (TpuScanEngine(interpret=True) under FASIM_SCAN16=1).

The kernel itself runs only on the card (chip_smoke.py holds it against
the same plain version there).  The model repeats its arithmetic step for
step: two pairs a register as int16 halves with wrapping adds (the pair
2k in the low half), the prmt byte pick with sign replication from the
row's 8-byte table by the column's 16-bit selector, the cell's G = H - 16
against the table's s + 16, kH0 (-16) above the query and the F sentinel
kTop (-16384), the balanced rows per lane of sw_colmax.cuh:sweep_rows, the
zero-score rows the kernel adds above row 0, the lane hand-off (a shuffle
up by one lane), the strip hand-off through the scratch row, the emit of
column j on lane j % 32 and the warp-wide max reduction (a shuffle xor
butterfly).  It runs both forms of the cell; by default the one the
kernel takes, the short F chain below 16 rows a lane and the long one at
16 (scan16.cu).  Two mutants must fail it: the per-pair max
taken from lane 31's columns only, and the selector's halves swapped.
Every output is an integer: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from fasim_tpu import rules
from fasim_tpu.kernels.tpu import TpuScanEngine
from fasim_tpu_torch.kernels import engine as engine_mod
from fasim_tpu_torch.kernels import scan
from fasim_tpu_torch.kernels.engine import TorchScanEngine

WARP = 32
MAX_ROWS = 16
K_H0 = -16
K_TOP = -16384
K_MIN = -32768
I16 = np.int16
# a transform subset of varied rules (T even: K7 pairs 2k with 2k + 1);
# 25 (a high half) and 31 (a low half) score GA repeats against GA repeats
SCANS = (0, 5, 17, 25, 31, 41)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _seq(rng, n, alphabet=b"ACGT"):
    return np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), n)].copy()


def _selector(ca, cb):
    """CellS16x2T::selector: byte ca, its sign, byte cb, its sign."""
    ca = np.asarray(ca, np.uint32)
    cb = np.asarray(cb, np.uint32)
    return ca | (ca | 8) << 4 | cb << 8 | (cb | 8) << 12


def _prmt(lo, hi, sel):
    """prmt.b32 d, lo, hi, sel (default mode) on uint32 arrays: selector
    nibble i picks byte (nibble & 7) of hi:lo into byte i, replicating
    that byte's sign bit when the nibble's bit 3 is set."""
    src = (hi.astype(np.uint64) << 32) | lo.astype(np.uint64)
    out = np.zeros(np.broadcast(lo, sel).shape, np.uint64)
    for i in range(4):
        nib = (sel.astype(np.uint64) >> (4 * i)) & 0xF
        byte = (src >> (8 * (nib & 7))) & 0xFF
        sign = np.where(byte & 0x80, 0xFF, 0).astype(np.uint64)
        out |= np.where(nib & 8, sign, byte) << (8 * i)
    return out.astype(np.uint32)


def _halves(w):
    """uint32 words -> int16[..., 2], the low half first."""
    return np.stack([w & 0xFFFF, w >> 16], -1).astype(np.uint16).view(I16)


# the s16x2 forms, per half, the add wrapping in int16
def _add(a, b):
    return (a.astype(np.int32) + b).astype(I16)


def _viaddmax(a, b, c):
    return np.maximum(_add(a, b), c)


def _viaddmax_relu(a, b, c):
    return np.maximum(np.maximum(_add(a, b), c), I16(0))


def _vimax_relu(a, b):
    return np.maximum(np.maximum(a, b), I16(0))


def _k7_model(codes, tab, m16, short=None, mutant=None):
    """The kernel's sweep for pair code rows int[S * T, N] (T even) and the
    table uint8[>= m16, 8]: (column maxima uint8[S * T, N], per-pair max
    int32[S * T]).  short picks the cell's form (None: the kernel's, the
    short F chain below 16 rows a lane); mutant "lane31" takes the per-pair
    max from lane 31's columns alone, "swap" swaps the selector's
    halves."""
    rows_all, N = codes.shape
    P = rows_all // 2
    ca, cb = codes[0::2], codes[1::2]  # pair 2k low, 2k + 1 high
    sels = _selector(cb, ca) if mutant == "swap" else _selector(ca, cb)
    words = np.ascontiguousarray(tab).view(np.uint32)  # [rows, 2]: lo, hi
    nstrips = -(-m16 // (WARP * MAX_ROWS))
    rpt = -(-m16 // (WARP * nstrips))
    pad = nstrips * WARP * rpt - m16
    if short is None:
        short = rpt < MAX_ROWS
    lanes = np.arange(WARP)
    zero = np.uint32(0x10101010)  # zero_query(): s + 16 = 16
    bh = np.zeros((P, N, 2), I16)
    bf = np.zeros((P, N, 2), I16)
    bc = np.zeros((P, N, 2), I16)
    colmax = np.zeros((P, N, 2), I16)
    lane_max = np.zeros((P, WARP, 2), I16)
    for strip in range(nstrips):
        first, last = strip == 0, strip == nstrips - 1
        rows = (strip * WARP + lanes)[:, None] * rpt - pad + np.arange(rpt)
        real = rows >= 0
        tlo = np.where(real, words[np.maximum(rows, 0), 0], zero)
        thi = np.where(real, words[np.maximum(rows, 0), 1], zero)
        g = np.full((P, WARP, rpt, 2), K_H0, I16)
        e = np.zeros((P, WARP, rpt, 2), I16)
        up_prev = np.full((P, WARP, 2), K_H0, I16)
        out_h = np.full((P, WARP, 2), K_H0, I16)
        out_f = np.full((P, WARP, 2), K_TOP, I16)
        out_c = np.zeros((P, WARP, 2), I16)
        for step in range(N + WARP - 1):
            # __shfl_up_sync(.., 1): lane k reads lane k - 1, lane 0 itself
            in_h = np.concatenate([out_h[:, :1], out_h[:, :-1]], 1)
            in_f = np.concatenate([out_f[:, :1], out_f[:, :-1]], 1)
            in_c = np.concatenate([out_c[:, :1], out_c[:, :-1]], 1)
            j = step - lanes
            act = ((j >= 0) & (j < N))[None, :, None]
            jj = np.clip(j, 0, N - 1)
            if first:
                in_h[:, 0], in_f[:, 0], in_c[:, 0] = K_H0, K_TOP, 0
            else:
                in_h[:, 0] = bh[:, jj[0]]
                in_f[:, 0] = bf[:, jj[0]]
                in_c[:, 0] = bc[:, jj[0]]
            sel = sels[:, jj]  # [P, WARP]
            diag = up_prev.copy()
            up_prev = np.where(act, in_h, up_prev)
            gu = _viaddmax(in_h, 16, K_MIN) if short else in_h.copy()
            f, cm = in_f.copy(), in_c.copy()
            for r in range(rpt):
                s = _halves(_prmt(tlo[None, :, r], thi[None, :, r], sel))
                ev = _viaddmax(e[:, :, r], -4, g[:, :, r])
                tmp = _viaddmax_relu(diag, s, ev)
                f = _viaddmax(f, -4, gu)
                hv = _viaddmax(f, -16, tmp) if short else _vimax_relu(tmp, f)
                diag = g[:, :, r].copy()
                g[:, :, r] = np.where(act, _viaddmax(hv, -16, K_MIN),
                                      g[:, :, r])
                e[:, :, r] = np.where(act, ev, e[:, :, r])
                gu = tmp if short else g[:, :, r].copy()
                cm = _vimax_relu(cm, hv)
            out_h = np.where(act, g[:, :, rpt - 1] if short else gu, out_h)
            out_f = np.where(act, f, out_f)
            out_c = np.where(act, cm, out_c)
            if act[0, WARP - 1, 0]:
                jl = jj[WARP - 1]
                if last:  # emitted on lane jl % 32
                    colmax[:, jl] = out_c[:, WARP - 1]
                    lane_max[:, jl % WARP] = _vimax_relu(
                        lane_max[:, jl % WARP], out_c[:, WARP - 1])
                else:
                    bh[:, jl] = out_h[:, WARP - 1]
                    bf[:, jl] = out_f[:, WARP - 1]
                    bc[:, jl] = out_c[:, WARP - 1]
    if mutant == "lane31":
        gmax = lane_max[:, WARP - 1]
    else:
        for d in (16, 8, 4, 2, 1):  # __shfl_xor_sync butterfly
            lane_max = _vimax_relu(lane_max, lane_max[:, lanes ^ d])
        gmax = lane_max[:, 0]
    # halves -> pairs 2k, 2k + 1 (both >= 0)
    cm = np.minimum(colmax.transpose(0, 2, 1).reshape(rows_all, N), 255)
    return cm.astype(np.uint8), gmax.reshape(rows_all).astype(np.int32)


def _model_wrapper(short=None, mutant=None):
    """scan_colmax16's signature on the model (CPU tensors)."""
    def run(bases, bases_rev, lut6, istr, qp, tab, m16, thresh_alphabet,
            want_cm=True):
        assert tab.thresh_alphabet == thresh_alphabet
        S, N = bases.shape
        T = lut6.shape[0]
        codes = scan._pair_codes(bases, bases_rev, lut6, istr).numpy()
        cm, gm = _k7_model(codes, tab.data.numpy(), m16, short, mutant)
        cm = torch.from_numpy(cm).view(S, T, N)
        return (cm if want_cm else None), torch.from_numpy(gm).view(S, T)
    return run


def _plain_scores(qp: np.ndarray, thresh: bool) -> np.ndarray:
    """int[mp2, 8] by the rule scan_colmax16_ref reads: s = hi where the
    code equals q, else lo; the threshold alphabet's N (5) scores nval."""
    c = np.arange(8)[None, :]
    s = np.where(c == qp[0][:, None], qp[1][:, None], qp[2][:, None])
    if thresh:
        s = np.where(c == 5, qp[3][:, None], s)
    return s


@pytest.mark.parametrize("thresh", [False, True])
@pytest.mark.parametrize("query", [b"ACGT", b"ACGTU", b"ACGTUNacgtu"])
def test_scan16_table_scores_every_row_and_code(query, thresh):
    """For the query rows of the JAX package's engine (built on the CPU),
    the table's byte (row, code) is the plain score + 16 for every code
    0..7 and row; the phantom rows past the query hold 16s; the port's
    engine derives the same table from its own rows."""
    rng = np.random.default_rng(len(query) + 7 * thresh)
    m = 203
    rna = _seq(rng, m, query)
    tpu = TpuScanEngine(rna, interpret=True)
    qp = np.array(tpu.qp2_thresh if thresh else tpu.qp2_ssw)
    table = scan.scan16_table(torch.from_numpy(qp), thresh)
    assert table.thresh_alphabet == thresh
    tab = table.data.numpy()
    assert tab.shape == (qp.shape[1], 8) and tab.dtype == np.uint8
    np.testing.assert_array_equal(tab.astype(np.int64) - 16,
                                  _plain_scores(qp, thresh))
    np.testing.assert_array_equal(tab[m:], 16)
    eng = TorchScanEngine(rna, device="cpu")
    got = eng._dev["stab16_thresh" if thresh else "stab16_ssw"]
    assert got.thresh_alphabet == thresh
    assert torch.equal(got.data, table.data)


@pytest.mark.parametrize("thresh", [False, True])
def test_scan_colmax16_refuses_the_other_alphabets_table(thresh):
    """The kernel reads only the table, the plain version only qp and the
    alphabet flag: scan_colmax16 refuses a table of the other alphabet,
    K1's table or bare bytes on every device, so the two cannot score
    differently."""
    rna = np.frombuffer(b"ACGTNUACGT", np.uint8).copy()
    eng = TorchScanEngine(rna, device="cpu")
    eng.setup_scans(rules.scan_list(0, 0)[:2])
    segs = torch.from_numpy(np.frombuffer(b"ACGTACGTNN", np.uint8)[None]
                            .copy())
    bases, bases_rev = scan.decode_bases(
        segs, torch.tensor([10], dtype=torch.int32))
    d = eng._dev
    alpha, other = ("thresh", "ssw") if thresh else ("ssw", "thresh")
    args = (bases, bases_rev, d[f"lut6_{alpha[0]}"], d["istr"],
            d[f"qp2_{alpha}"])
    cm, gm = scan.scan_colmax16(*args, d[f"stab16_{alpha}"], eng.m16, thresh)
    want_cm, want_gm = scan.scan_colmax16_ref(*args, eng.m16, thresh)
    assert torch.equal(cm, want_cm) and torch.equal(gm, want_gm)
    for wrong in (d[f"stab16_{other}"], d[f"stab_{alpha}"],
                  d[f"stab16_{alpha}"].data):
        with pytest.raises(ValueError, match="alphabet"):
            scan.scan_colmax16(*args, wrong, eng.m16, thresh)


def _case(m, query, rng):
    """A query of m rows over `query` and a batch of two segments (44 and
    31 columns of 44) with a run of the query's own bases, N and lowercase
    bytes; for b"GA" a GA-repeat query and 128 columns, the first segment
    holding a GA run of 100."""
    n = 128 if query == b"GA" else 44
    segs = np.zeros((2, n), np.uint8)
    lens = np.array([n, 31], np.int32)
    for i, ln in enumerate(lens):
        segs[i, :ln] = _seq(rng, ln, b"ACGTNacgt")
    if query == b"GA":
        rna = np.frombuffer(b"GA" * m, np.uint8)[:m].copy()
        segs[0, 10:110] = np.frombuffer(b"GA" * 50, np.uint8)
    else:
        rna = _seq(rng, m, query)
        segs[0, 4:30] = np.where(rna[:26] == ord("U"), ord("T"), rna[:26])
    return rna, segs, lens


def _inputs(rna, segs, lens, alpha):
    eng = TorchScanEngine(rna, device="cpu")
    eng.setup_scans([rules.scan_list(0, 0)[i] for i in SCANS])
    bases, bases_rev = scan.decode_bases(torch.from_numpy(segs),
                                         torch.from_numpy(lens))
    d = eng._dev
    args = (bases, bases_rev, d[f"lut6_{alpha[0]}"], d["istr"],
            d[f"qp2_{alpha}"])
    return eng, args, d[f"stab16_{alpha}"]


# one strip of 2 rows a lane (m16 = 64), one of 6 (GA repeats past 251),
# one of 16 (m16 = 512, where the kernel takes the long form), two strips
# of 9 (m16 = 528, 48 zero rows above row 0) with a U query and three of 11
# (1,040)
@pytest.mark.parametrize("short", [False, True], ids=["long", "short"])
@pytest.mark.parametrize("thresh", [False, True])
@pytest.mark.parametrize("m,query", [(61, b"ACGT"), (190, b"GA"),
                                     (509, b"ACGT"), (527, b"ACGTU"),
                                     (1033, b"ACGT")])
def test_k7_model_matches_ref(m, query, thresh, short):
    rng = np.random.default_rng(m + thresh)
    rna, segs, lens = _case(m, query, rng)
    alpha = "thresh" if thresh else "ssw"
    eng, args, tab = _inputs(rna, segs, lens, alpha)
    want_cm, want_max = scan.scan_colmax16_ref(*args, eng.m16, thresh)
    got_cm, got_max = _model_wrapper(short)(*args, tab, eng.m16, thresh)
    assert int(want_max.max()) >= (251 if query == b"GA" else 20)
    assert torch.equal(got_cm, want_cm)
    assert torch.equal(got_max, want_max)


@pytest.mark.parametrize("m,query", [(61, b"ACGT"), (190, b"GA"),
                                     (509, b"ACGT"), (527, b"ACGTU"),
                                     (1033, b"ACGT")])
def test_k7_model_matches_pallas_int16(m, query, monkeypatch):
    """The port's engine with the model in K7's place equals the JAX
    package's int16 Pallas path in interpret mode on the same batch:
    thresholds and column maxima, the threshold-alphabet pass included
    (the batch holds N and lowercase bytes)."""
    rng = np.random.default_rng(3 * m)
    rna, segs, lens = _case(m, query, rng)
    # the Pallas kernel takes a batch of whole 128-column tiles
    segs = np.pad(segs, ((0, 0), (0, -segs.shape[1] % 128)))
    scans = [rules.scan_list(0, 0)[i] for i in SCANS]
    monkeypatch.setenv("FASIM_SCAN16", "1")
    tpu = TpuScanEngine(rna, interpret=True)
    tpu.setup_scans(scans)
    assert tpu.scan16
    port = TorchScanEngine(rna, device="cpu")
    port.setup_scans(scans)
    calls = []

    def model(*args, **kw):
        calls.append(args[6])
        return _model_wrapper()(*args, **kw)

    monkeypatch.setattr(engine_mod, "scan_colmax16", model)
    g_t, c_t = (np.asarray(a) for a in tpu.scan_segments(segs, lens))
    g_p, c_p = (a.numpy() for a in port.scan_segments(segs, lens))
    assert len(calls) == 2  # the ssw and the threshold-alphabet pass
    np.testing.assert_array_equal(g_p, g_t)
    np.testing.assert_array_equal(c_p, c_t)


@pytest.mark.parametrize("mutant", ["lane31", "swap"])
def test_k7_model_mutants_fail(mutant):
    """The model catches a per-pair max read from lane 31's columns alone
    (the old sweep's emit lane) and a selector whose halves are swapped,
    on a case the unmutated model gets right."""
    rng = np.random.default_rng(11)
    rna, segs, lens = _case(190, b"ACGT", rng)
    eng, args, tab = _inputs(rna, segs, lens, "ssw")
    want = scan.scan_colmax16_ref(*args, eng.m16, False)
    good = _model_wrapper()(*args, tab, eng.m16, False)
    assert all(torch.equal(a, b) for a, b in zip(good, want))
    bad = _model_wrapper(mutant=mutant)(*args, tab, eng.m16, False)
    assert not all(torch.equal(a, b) for a, b in zip(bad, want))


_SASS16 = """
        Function : _ZN12_GLOBAL__N_113scan16_kernelILi2EEEvPKhS2_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.U16 R3, [R0] ;
        /*0020*/                   SHFL.UP PT, R2, R3, 0x1, RZ ;
        /*0030*/               @P0 BRA 0xb0 ;
        /*0040*/                   PRMT R4, R5, R6, R3 ;
        /*0050*/                   VIADDMNMX.S16x2.RELU R7, R4, R8, R9, !PT ;
        /*0060*/                   VIADDMNMX.S16x2 R9, R9, R10, R7, !PT ;
        /*0070*/                   PRMT R4, R5, R6, R3 ;
        /*0080*/                   VIADDMNMX.S16x2.RELU R10, R4, R8, R7, !PT ;
        /*0090*/                   VIMNMX3.S16x2.RELU R11, R11, R10, R7, !PT ;
        /*00a0*/                   IMAD.MOV.U32 R8, RZ, RZ, R9 ;
        /*00b0*/                   STS [R1], R2 ;
        /*00c0*/               @P1 BRA 0x10 ;
        /*00d0*/                   EXIT ;
"""


def test_sass_loop_counts_the_16_bit_forms():
    """chip_smoke's SASS count on K7's opcodes, the s16x2 forms with their
    lane-type modifier (as cuobjdump prints them for sm_90a): one
    VIADDMNMX.S16x2.RELU a row marks the column block, and every DPX form
    counts among the cells' own instructions."""
    import chip_smoke

    got = chip_smoke.sass_loop("scan16_kernelILi2E", _SASS16)
    assert got["loop"] == 12 and got["loop_integer"] == 6
    assert (got["block"], got["cells"], got["integer"], got["moves"],
            got["cell_ops"]) == (7, 2, 6, 1, 7)
    assert got["opcodes"]["VIADDMNMX.S16x2.RELU"] == 2
