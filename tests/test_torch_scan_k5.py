"""K5 on K1's DPX cell (csrc/scan_codes.cu on sw_colmax.cuh:CellI32Dpx and
sweep_columns_fixed) on the CPU: its score-class table
(`scan_codes_table`) against the plain scores, and a bit-level numpy model
of the kernel's sweep against `scan_codes_colmax_ref`.

The kernel itself runs only on the card (chip_smoke.py holds it against
the same plain version there).  The model repeats what the kernel does:
the fold of a code row as it is copied into shared memory (U to T in the
threshold alphabet, codes >= 8 to the pad code), K1's cell in its short
form (`CellI32DpxT<true>`: F + 16 down the rows, each row's F from the
row above's F and tmp, H = max(tmp, F)), the zero-score rows
above row 0, the staging blocks of 32 columns, and the plan's warps: warp
w of W runs strips w, w + W, ..., hands each strip's bottom row to warp w +
1 through a ring of two 32-column slots, meeting it on a named barrier once
a block, and warp W - 1 hands its strips to warp 0 through the scratch row
(the wrap), publishing each block in a shared count that warp 0 waits for.
The warps run as generators, interleaved at uneven speeds in orders drawn
from a seed, each waiting where the kernel's warp waits, so a hand-off read
before it is written or from another slot or row changes the output.  Every
output is an integer: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from fasim_tpu.kernels.tpu import TpuScanEngine
from fasim_tpu_torch.kernels import scan_codes
from fasim_tpu_torch.kernels.engine import TorchScanEngine
from fasim_tpu_torch.rules import SSW_ENC, THRESH_ENC
from test_torch_scan_k1 import (K_TOP, WARP, _prmt, _selector, _viaddmax,
                                _viaddmax_relu)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _seq(rng, n, alphabet=b"ACGT"):
    return np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), n)].copy()


def _fold(codes, alphabet):
    """The kernel's fold of a code row: every code >= 8 to the alphabet's
    pad code, then U (4) to T (3) in the threshold alphabet."""
    c = np.where(codes >= 8, scan_codes.PAD_CODE[alphabet], codes)
    return np.where(c == 4, 3, c) if alphabet == "thresh" else c


def _k5_model(codes, tab, m16, plan, alphabet, seed=0, mutant=None):
    """The kernel's column maxima int32[P, N] of code rows int[P, N] (any
    byte), its table uint8[64 + >= m16] and plan (rows a lane, warps).
    mutant names a deliberate fault: "slot", a warp reads the ring slot
    after the one written; "wrap", warp 0 takes the top boundary in place
    of the scratch row."""
    P, N = codes.shape
    rows, warps = plan
    c = _fold(np.asarray(codes), alphabet)
    words = tab[:64].view(np.uint32).reshape(8, 2)  # per code: (lo, hi)
    cls = tab[64:].astype(np.int64)
    nstrips = -(-m16 // (WARP * rows))
    nblocks = -(-N // WARP)
    pad = nstrips * WARP * rows - m16
    pipe = warps > 1
    lanes = np.arange(WARP)
    stage_in = np.zeros((3, P, WARP), np.int32)
    stage_out = np.zeros((warps, 3, P, WARP), np.int32)
    ring = np.zeros((max(warps - 1, 1), 2, 3, P, WARP), np.int32)
    bnd = np.zeros((3, P, N), np.int32)
    out = np.zeros((P, N), np.int32)
    shared = {"wrap_done": 0}
    bars = {}  # named barrier -> [warps arrived, completions]

    def bar_sync(bid):
        bar = bars.setdefault(bid, [0, 0])
        done = bar[1]
        bar[0] += 1
        if bar[0] == 2:
            bar[0], bar[1] = 0, done + 1
        yield "arrived"
        while bar[1] == done:
            yield "blocked"

    def wait_count(target):
        while shared["wrap_done"] < target:
            yield "blocked"

    def fetch(nxt, cols):
        ok = cols < N
        for a in range(3):
            nxt[a] = np.where(ok, bnd[a][:, np.minimum(cols, N - 1)], nxt[a])

    def warp(w):
        for strip in range(w, nstrips, warps):
            first, last = strip == 0, strip == nstrips - 1
            ring_in = pipe and not first and w > 0
            ring_out = pipe and not last and w < warps - 1
            moved = (strip - w) // warps * nblocks
            wrap_in = (strip // warps - 1) * nblocks
            wrap_out = ((strip + 1) // warps - 1) * nblocks
            top = first or (mutant == "wrap" and w == 0)
            r = (strip * WARP + lanes)[:, None] * rows - pad + np.arange(rows)
            sel = _selector(np.where(r >= 0, cls[np.maximum(r, 0)], 0))
            sel = np.broadcast_to(sel, (P, WARP, rows))
            g = np.full((P, WARP, rows), -16, np.int32)
            e = np.zeros((P, WARP, rows), np.int32)
            up_prev = np.full((P, WARP), -16, np.int32)
            out_h = np.full((P, WARP), -16, np.int32)
            out_f = np.full((P, WARP), K_TOP, np.int32)
            out_c = np.zeros((P, WARP), np.int32)
            nxt = [out_h.copy(), out_f.copy(), out_c.copy()]
            blk = stage_in  # the block above the strip
            if not first and not ring_in:
                if pipe:
                    yield from wait_count(wrap_in + 1)
                fetch(nxt, lanes)
            for step in range(N + WARP - 1):
                k = step % WARP
                if not first and k == 0:
                    if ring_in:
                        if step < N:
                            yield from bar_sync(w)
                            slot = moved + step // WARP + (mutant == "slot")
                            blk = ring[w - 1, slot % 2]
                    else:
                        stage_in[:] = nxt
                        if pipe:
                            yield from wait_count(
                                wrap_in + min(step // WARP + 2, nblocks))
                        fetch(nxt, step + WARP + lanes)
                # __shfl_up_sync(.., 1): lane k reads lane k - 1
                in_h = np.concatenate([out_h[:, :1], out_h[:, :-1]], 1)
                in_f = np.concatenate([out_f[:, :1], out_f[:, :-1]], 1)
                in_c = np.concatenate([out_c[:, :1], out_c[:, :-1]], 1)
                if top:
                    in_h[:, 0], in_f[:, 0], in_c[:, 0] = -16, K_TOP, 0
                else:
                    in_h[:, 0], in_f[:, 0], in_c[:, 0] = blk[:, :, k]
                j = step - lanes
                act = (j >= 0) & (j < N)
                col = c[:, np.clip(j, 0, N - 1)]
                lo, hi = words[col, 0], words[col, 1]
                diag = up_prev.copy()
                up_prev = np.where(act, in_h, up_prev)
                # the short chain: f holds F + 16; row 0 takes the H above
                # (carry_in), row r the tmp of row r - 1
                hu, f, cm = in_h + 16, in_f.copy(), in_c.copy()
                for q in range(rows):
                    s = _prmt(lo, hi, sel[:, :, q])
                    ev = _viaddmax(e[:, :, q], -4, g[:, :, q])
                    tmp = _viaddmax_relu(diag, s, ev)
                    f = _viaddmax(f, -4, hu)
                    hv = _viaddmax(f, -16, tmp)
                    diag = g[:, :, q].copy()
                    g[:, :, q] = np.where(act, hv - 16, g[:, :, q])
                    e[:, :, q] = np.where(act, ev, e[:, :, q])
                    hu = tmp
                    cm = np.maximum(cm, hv)
                out_h = np.where(act, g[:, :, rows - 1], out_h)  # carry_out
                out_f = np.where(act, f, out_f)
                out_c = np.where(act, cm, out_c)
                j31 = step - (WARP - 1)
                if j31 >= 0:
                    dst = (ring[w, (moved + j31 // WARP) % 2] if ring_out
                           else stage_out[w])
                    for a, v in enumerate((out_h, out_f, out_c)):
                        dst[a][:, j31 % WARP] = v[:, WARP - 1]
                    if j31 % WARP == WARP - 1 or j31 == N - 1:
                        if ring_out:
                            yield from bar_sync(w + 1)
                        else:
                            jb = j31 - j31 % WARP + lanes
                            ok = jb <= j31
                            if last:
                                out[:, jb[ok]] = dst[2][:, ok]
                            else:
                                bnd[:, :, jb[ok]] = dst[:, :, ok]
                                if pipe:
                                    shared["wrap_done"] = (
                                        wrap_out + j31 // WARP + 1)
                yield "step"

    running = {w: warp(w) for w in range(warps)}
    rng = np.random.default_rng(seed)
    while running:
        moved_on = False
        for w in rng.permutation(sorted(running)):
            for _ in range(rng.integers(1, 4)):  # uneven speeds
                try:
                    moved_on |= next(running[w]) != "blocked"
                except StopIteration:
                    del running[w]
                    moved_on = True
                    break
        if not moved_on:
            raise RuntimeError("the model's warps deadlocked")
    return out


def _plain_scores(qprops: np.ndarray, alphabet: str) -> np.ndarray:
    """int[256, mp]: tpu.py:_score_col's score of every code against every
    query row, written out from its rule (score_profile's contract)."""
    q, maska, qn, valid = (qprops[r][None, :] for r in range(4))
    code = np.arange(256)[:, None]
    if alphabet == "ssw":
        s = np.where((code == q) & (maska != 0), 5, -4)
    else:
        match = (code == q) | ((maska != 0) & ((code == 3) | (code == 4)))
        s = np.where((qn != 0) | (code == 5), -1, np.where(match, 5, -4))
    return np.where(valid != 0, s, 0)


@pytest.mark.parametrize("alphabet", ["ssw", "thresh"])
@pytest.mark.parametrize("query", [b"ACGT", b"ACGTU", b"ACGTUNacgtu"])
def test_scan_codes_table_scores_every_row_and_code(query, alphabet):
    """For the query rows of the JAX package's engine (built on the CPU;
    the port's make_qprops equals them, test_torch_state.py), the
    table's byte of (row class, folded code) is the plain score + 16 for
    every code 0..255 and row; class 0 scores 0; at most 6 classes."""
    rng = np.random.default_rng(len(query) + 7 * (alphabet == "thresh"))
    rna = _seq(rng, 203, query)
    tpu = TpuScanEngine(rna, interpret=True)
    qprops = np.array(getattr(tpu, f"qprops_{alphabet}"))
    table = scan_codes.scan_codes_table(torch.from_numpy(qprops), alphabet)
    assert table.alphabet == alphabet
    tab = table.data.numpy()
    assert tab.shape == (64 + qprops.shape[1],)
    scores = tab[:64].reshape(8, 8).T.astype(np.int64) - 16  # [class, code]
    cls = tab[64:].astype(np.int64)
    folded = _fold(np.arange(256), alphabet)
    np.testing.assert_array_equal(scores[cls][:, folded].T,
                                  _plain_scores(qprops, alphabet))
    np.testing.assert_array_equal(scores[0], 0)
    assert cls.max() < 6


@pytest.mark.parametrize("alphabet", ["ssw", "thresh"])
def test_scan_codes_colmax_refuses_the_other_alphabets_table(alphabet):
    """The kernel reads only the table, the plain version only qprops and
    the alphabet: the wrapper refuses a table of the other alphabet (or
    bare bytes) on every device, so the two cannot score differently."""
    rna = np.frombuffer(b"ACGTNUACGT", np.uint8).copy()
    eng = TorchScanEngine(rna, device="cpu")
    other = "thresh" if alphabet == "ssw" else "ssw"
    codes = torch.from_numpy(np.array([[0, 1, 2, 3, 4, 5, 9, 200]],
                                      np.uint8))
    args = (codes, eng._dev[f"qprops_{alphabet}"])
    got = scan_codes.scan_codes_colmax(*args, eng._dev[f"ctab_{alphabet}"],
                                       eng.m16, alphabet)
    want = scan_codes.scan_codes_colmax_ref(*args, eng.m16, alphabet)
    assert torch.equal(got, want)
    for wrong in (eng._dev[f"ctab_{other}"],
                  eng._dev[f"ctab_{alphabet}"].data):
        with pytest.raises(ValueError, match="alphabet"):
            scan_codes.scan_codes_colmax(*args, wrong, eng.m16, alphabet)


def _rows(rng, rna, alphabet, n):
    """Code rows uint8[3, n] of one segment's transforms: ragged (pad
    codes after the real length), with codes >= 8 and a run of the
    query's own codes, so that columns score well."""
    enc = SSW_ENC if alphabet == "ssw" else THRESH_ENC
    codes = np.full((3, n), scan_codes.PAD_CODE[alphabet], np.uint8)
    for i, ln in enumerate((n, n - 9, n // 2)):
        codes[i, :ln] = enc[_seq(rng, ln, b"ACGTNUacg")]
    codes[0, 5:45] = enc[rna[:40]]
    codes[1, 3:33] = enc[rna[10:40]]
    hits = rng.random((3, n)) < 0.05
    codes[hits] = rng.choice([8, 9, 77, 200, 255], int(hits.sum()))
    return codes


# (m, plan): one strip; strips = warps; strips > warps (the wrap, three
# rounds); one warp over three strips (the one-warp sweep of a packed
# batch: K1's scratch row).  N = 70: three blocks, an odd count, so the
# ring slots continue across a warp's strips.
PLANS = [(61, (2, 2)), (190, (2, 3)), (300, (2, 2)), (300, (4, 1))]


@pytest.mark.parametrize("alphabet", ["ssw", "thresh"])
@pytest.mark.parametrize("m,plan", PLANS)
def test_k5_model_matches_ref(m, plan, alphabet):
    rng = np.random.default_rng(m + plan[1] + 10 * (alphabet == "thresh"))
    rna = _seq(rng, m, b"ACGTU")
    eng = TorchScanEngine(rna, device="cpu")
    codes = _rows(rng, rna, alphabet, 70)
    want = scan_codes.scan_codes_colmax_ref(
        torch.from_numpy(codes), eng._dev[f"qprops_{alphabet}"], eng.m16,
        alphabet).numpy()
    tab = eng._dev[f"ctab_{alphabet}"].data.numpy()
    for seed in range(2):
        got = _k5_model(codes, tab, eng.m16, plan, alphabet, seed=seed)
        np.testing.assert_array_equal(got, want)
    assert want.max() >= 60


@pytest.mark.parametrize("mutant", ["slot", "wrap"])
def test_k5_model_mutants_fail(mutant):
    """A ring slot off by one and a wrap that skips the scratch row each
    change the output of the strips > warps case."""
    rng = np.random.default_rng(5)
    rna = _seq(rng, 300, b"ACGT")
    eng = TorchScanEngine(rna, device="cpu")
    codes = _rows(rng, rna, "ssw", 70)
    want = scan_codes.scan_codes_colmax_ref(
        torch.from_numpy(codes), eng._dev["qprops_ssw"], eng.m16,
        "ssw").numpy()
    got = _k5_model(codes, eng._dev["ctab_ssw"].data.numpy(), eng.m16,
                    (2, 2), "ssw", mutant=mutant)
    assert not np.array_equal(got, want)


_SASS_STUB = """
        Function : _ZN12_GLOBAL__N_117scan_codes_kernelILi2ELb1EEEvPKh
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS.U8 R3, [R0] ;
        /*0020*/                   IADD3 R3, R3, 0x1, RZ ;
        /*0030*/                   BRA.DIV UR4, 0xc0 ;
        /*0040*/                   NOP ;
        /*0050*/                   SHFL.UP PT, R2, R3, 0x1, RZ ;
        /*0060*/               @P0 BRA 0xa0 ;
        /*0070*/                   PRMT R4, R5, R6, RZ ;
        /*0080*/                   VIADDMNMX.RELU R7, R4, R8, R9, !PT ;
        /*0090*/                   VIADDMNMX.RELU R10, R4, R8, R7, !PT ;
        /*00a0*/                   STS [R1], R2 ;
        /*00b0*/               @P1 BRA 0x10 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   WARPSYNC.COLLECTIVE R4, 0xe0 ;
        /*00e0*/                   BRA 0x50 ;
"""


def test_sass_loop_skips_divergence_stubs():
    """chip_smoke's step loop is the innermost predicated backward branch
    around the first SHFL.UP: the unconditional jump back from an
    out-of-line divergence path (shorter here) is not a loop."""
    import chip_smoke

    got = chip_smoke.sass_loop("scan_codes_kernelILi2ELb1E", _SASS_STUB)
    assert got["loop"] == 11 and got["cells"] == 2
