"""K1's int32 DPX cell (csrc/sw_colmax.cuh:CellI32Dpx, csrc/scan.cu) on the
CPU: its score-class table (`scan_table`) against the plain scores, and a
bit-level numpy model of the kernel's sweep against `scan_colmax_ref`.

The kernel itself runs only on the card (chip_smoke.py holds it against
the same plain version there).  The model repeats its arithmetic step for
step: the prmt byte pick with sign replication from the column's 8-byte
table, the cell's G = H - 16 with the table's s + 16, the relu on the
diagonal max only, the F sentinel kTop above row 0, the balanced rows per
lane of sw_colmax.cuh:sweep_rows, the zero-score rows the kernel adds
above row 0, the lane hand-off (a shuffle up by one lane) and the strip
hand-off through the scratch row.  Every output is an integer: the
tolerance is 0.
"""

import numpy as np
import pytest
import torch

from fasim_tpu import rules
from fasim_tpu.kernels.tpu import TpuScanEngine
from fasim_tpu_torch.kernels import scan
from fasim_tpu_torch.kernels.engine import TorchScanEngine

WARP = 32
MAX_ROWS = 16
K_TOP = -(1 << 30)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _seq(rng, n, alphabet=b"ACGT"):
    return np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), n)].copy()


def _selector(k):
    """CellI32Dpx::selector: byte k, its sign in the three bytes above."""
    k = np.asarray(k, np.uint32)
    return k | (k | 8) << 4 | (k | 8) << 8 | (k | 8) << 12


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
    return out.astype(np.uint32).view(np.int32)


def _viaddmax(a, b, c):
    return np.maximum(a + b, c)


def _viaddmax_relu(a, b, c):
    return np.maximum(np.maximum(a + b, c), 0)


def _k1_model(codes, tab, m16):
    """The kernel's sweep for pair code rows int[P, N] and the table
    uint8[64 + >= m16]: the column maxima int32[P, N] that lane 31 of the
    last strip emits."""
    P, N = codes.shape
    words = tab[:64].view(np.uint32).reshape(8, 2)  # per code: (lo, hi)
    cls = tab[64:].astype(np.int64)
    nstrips = -(-m16 // (WARP * MAX_ROWS))
    rpt = -(-m16 // (WARP * nstrips))
    pad = nstrips * WARP * rpt - m16
    lanes = np.arange(WARP)
    bh = np.zeros((P, N), np.int32)
    bf = np.zeros((P, N), np.int32)
    bc = np.zeros((P, N), np.int32)
    out = np.zeros((P, N), np.int32)
    for strip in range(nstrips):
        first, last = strip == 0, strip == nstrips - 1
        rows = (strip * WARP + lanes)[:, None] * rpt - pad + np.arange(rpt)
        k = np.where(rows >= 0, cls[np.maximum(rows, 0)], 0)
        sel = np.broadcast_to(_selector(k), (P, WARP, rpt))
        g = np.full((P, WARP, rpt), -16, np.int32)
        e = np.zeros((P, WARP, rpt), np.int32)
        up_prev = np.full((P, WARP), -16, np.int32)
        out_h = np.full((P, WARP), -16, np.int32)
        out_f = np.full((P, WARP), K_TOP, np.int32)
        out_c = np.zeros((P, WARP), np.int32)
        for step in range(N + WARP - 1):
            # __shfl_up_sync(.., 1): lane k reads lane k - 1, lane 0 itself
            in_h = np.concatenate([out_h[:, :1], out_h[:, :-1]], 1)
            in_f = np.concatenate([out_f[:, :1], out_f[:, :-1]], 1)
            in_c = np.concatenate([out_c[:, :1], out_c[:, :-1]], 1)
            j = step - lanes
            act = (j >= 0) & (j < N)
            jj = np.clip(j, 0, N - 1)
            if act[0]:
                if first:
                    in_h[:, 0], in_f[:, 0], in_c[:, 0] = -16, K_TOP, 0
                else:
                    in_h[:, 0] = bh[:, jj[0]]
                    in_f[:, 0] = bf[:, jj[0]]
                    in_c[:, 0] = bc[:, jj[0]]
            c = codes[:, jj] & 7
            lo, hi = words[c, 0], words[c, 1]
            diag = up_prev.copy()
            up_prev = np.where(act, in_h, up_prev)
            gu, f, cm = in_h.copy(), in_f.copy(), in_c.copy()
            for r in range(rpt):
                s = _prmt(lo, hi, sel[:, :, r])
                ev = _viaddmax(e[:, :, r], -4, g[:, :, r])
                tmp = _viaddmax_relu(diag, s, ev)
                f = _viaddmax(f, -4, gu)
                hv = np.maximum(tmp, f)
                diag = g[:, :, r].copy()
                g[:, :, r] = np.where(act, hv - 16, g[:, :, r])
                e[:, :, r] = np.where(act, ev, e[:, :, r])
                gu = g[:, :, r].copy()
                cm = np.maximum(cm, hv)
            out_h = np.where(act, gu, out_h)
            out_f = np.where(act, f, out_f)
            out_c = np.where(act, cm, out_c)
            if act[WARP - 1]:
                jl = jj[WARP - 1]
                if last:
                    out[:, jl] = cm[:, WARP - 1]
                else:
                    bh[:, jl] = out_h[:, WARP - 1]
                    bf[:, jl] = f[:, WARP - 1]
                    bc[:, jl] = cm[:, WARP - 1]
    return out


def _plain_scores(qp: np.ndarray, thresh: bool) -> np.ndarray:
    """int[mp2, 8] by the rule scan_colmax_ref reads: s = hi where the code
    equals q, else lo; the threshold alphabet's N (5) scores nval."""
    c = np.arange(8)[None, :]
    s = np.where(c == qp[0][:, None], qp[1][:, None], qp[2][:, None])
    if thresh:
        s = np.where(c == 5, qp[3][:, None], s)
    return s


@pytest.mark.parametrize("thresh", [False, True])
@pytest.mark.parametrize("query", [b"ACGT", b"ACGTU", b"ACGTUNacgtu"])
def test_scan_table_scores_every_row_and_code(query, thresh):
    """For the query rows of the JAX package's engine (built on the CPU;
    the port's make_qp2 equals them, test_torch_state.py), the
    table's byte of (row class, code) is the plain score + 16 for every
    code 0..7 and row; class 0 scores 0; make_qp2 builds at most 6
    classes."""
    rng = np.random.default_rng(len(query) + 7 * thresh)
    rna = _seq(rng, 203, query)
    tpu = TpuScanEngine(rna, interpret=True)
    qp = np.array(tpu.qp2_thresh if thresh else tpu.qp2_ssw)
    table = scan.scan_table(torch.from_numpy(qp), thresh)
    assert table.thresh_alphabet == thresh
    tab = table.data.numpy()
    assert tab.shape == (64 + qp.shape[1],)
    scores = tab[:64].reshape(8, 8).T.astype(np.int64) - 16  # [class, code]
    cls = tab[64:].astype(np.int64)
    np.testing.assert_array_equal(scores[cls], _plain_scores(qp, thresh))
    np.testing.assert_array_equal(scores[0], 0)
    assert cls.max() < 6


def test_scan_table_refuses_nine_classes():
    """Nine distinct score rows (8 rows and the zero row of the phantom
    rows) do not fit the kernel's 8 classes: scan_table raises, as it
    does for a score outside the table's byte; one row fewer fits."""
    qp = np.zeros((5, 128), np.int32)
    qp[0, :8] = np.arange(8) % 6
    qp[1, :8] = 5
    qp[2, :8] = np.where(np.arange(8) < 6, -4, -3)
    qp[0, 8:] = -1
    with pytest.raises(ValueError, match="classes"):
        scan.scan_table(torch.from_numpy(qp), False)
    ok = scan.scan_table(torch.from_numpy(qp[:, 1:]), False)  # 8 classes
    assert int(ok.data[64:].max()) == 7
    qp[1, 0] = 200
    with pytest.raises(ValueError, match="byte"):
        scan.scan_table(torch.from_numpy(qp), False)


@pytest.mark.parametrize("thresh", [False, True])
def test_scan_colmax_refuses_the_other_alphabets_table(thresh):
    """The kernel reads only the table, the plain version only qp and the
    alphabet flag: scan_colmax refuses a table of the other alphabet (or
    bare bytes) on every device, so the two cannot score differently."""
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
    cm, gm = scan.scan_colmax(*args, d[f"stab_{alpha}"], eng.m16, thresh)
    want_cm, want_gm = scan.scan_colmax_ref(*args, eng.m16, thresh)
    assert torch.equal(cm, want_cm) and torch.equal(gm, want_gm)
    for wrong in (d[f"stab_{other}"], d[f"stab_{alpha}"].data):
        with pytest.raises(ValueError, match="alphabet"):
            scan.scan_colmax(*args, wrong, eng.m16, thresh)


# one strip (m not a multiple of 16), m16 = 512 (one full strip), 528 (two
# strips, 48 zero rows above row 0), 1040 (three strips); a U query
@pytest.mark.parametrize("thresh", [False, True])
@pytest.mark.parametrize("m,query", [(61, b"ACGT"), (512, b"ACGT"),
                                     (520, b"ACGTU"), (1040, b"ACGT")])
def test_k1_model_matches_ref(m, query, thresh):
    rng = np.random.default_rng(m + thresh)
    rna = _seq(rng, m, query)
    scans = rules.scan_list(0, 0)
    eng = TorchScanEngine(rna, device="cpu")
    eng.setup_scans([scans[i] for i in (0, 5, 17, 30, 41, 47)])
    n = 44
    segs = np.zeros((2, n), np.uint8)
    lens = np.array([n, 31], np.int32)
    for i, ln in enumerate(lens):
        segs[i, :ln] = _seq(rng, ln, b"ACGTNacgt")
    # a run of the query's own bases, so that columns score well
    segs[0, 4:30] = np.where(rna[:26] == ord("U"), ord("T"), rna[:26])
    bases, bases_rev = scan.decode_bases(torch.from_numpy(segs),
                                         torch.from_numpy(lens))
    alpha = "thresh" if thresh else "ssw"
    d = eng._dev
    args = (bases, bases_rev, d[f"lut6_{alpha[0]}"], d["istr"],
            d[f"qp2_{alpha}"])
    want_cm, want_max = scan.scan_colmax_ref(*args, eng.m16, thresh)
    codes = scan._pair_codes(bases, bases_rev, d[f"lut6_{alpha[0]}"],
                             d["istr"]).numpy()
    got = _k1_model(codes, d[f"stab_{alpha}"].data.numpy(), eng.m16)
    got = got.reshape(want_cm.shape)
    assert int(want_max.max()) >= 20
    np.testing.assert_array_equal(np.minimum(got, 255), want_cm.numpy())
    np.testing.assert_array_equal(got.max(-1), want_max.numpy())


_SASS = """
        Function : _ZN12_GLOBAL__N_118scan_colmax_kernelILi2EEEvPKh
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.U8 R3, [R0] ;
        /*0020*/                   SHFL.UP PT, R2, R3, 0x1, RZ ;
        /*0030*/               @P0 BRA 0x80 ;
        /*0040*/                   PRMT R4, R5, R6, RZ ;
        /*0050*/                   VIADDMNMX.RELU R7, R4, R8, R9, !PT ;
        /*0060*/                   VIADDMNMX.RELU R10, R4, R8, R7, !PT ;
        /*0070*/                   IMAD.MOV.U32 R8, RZ, RZ, R9 ;
        /*0080*/                   STS [R1], R2 ;
        /*0090*/               @P1 BRA 0x10 ;
        /*00a0*/                   EXIT ;
"""


def test_sass_loop_counts_the_step_loop():
    """chip_smoke's SASS count of K1's step loop (the backward branch
    around the first SHFL.UP) and of its column block (the forward branch
    around the cells' VIADDMNMX.RELU), on a dump of that shape."""
    import chip_smoke

    got = chip_smoke.sass_loop("scan_colmax_kernelILi2E", _SASS)
    assert got["loop"] == 9 and got["loop_integer"] == 3
    assert (got["block"], got["cells"], got["integer"], got["moves"],
            got["cell_ops"]) == (4, 2, 3, 1, 4)
    assert got["opcodes"] == {"VIADDMNMX.RELU": 2, "PRMT": 1,
                              "IMAD.MOV.U32": 1}
