"""Port's candidate-window passes (K3 / K4 plain version through
TorchScanEngine on the CPU) vs the JAX package: `XlaScanEngine` (exact
everywhere) and, at small buckets, the Pallas kernels in interpret mode
as tests/test_window_pass.py runs them.

Every output is int32 (best, end_col, end_row): the tolerance is 0.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fasim_tpu import rules
from fasim_tpu.config import GAP_EXTEND, GAP_OPEN
from fasim_tpu.kernels import align as kalign
from fasim_tpu.kernels.xla import XlaScanEngine, _window_qp
from fasim_tpu_torch.kernels import engine as engine_mod
from fasim_tpu_torch.kernels import window
from fasim_tpu_torch.kernels.engine import TorchScanEngine


CHUNK = 1 << 16  # rows a 16-bit row key tells apart


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ru(x, m):
    return (x + m - 1) // m * m


def _rna(rng, m):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m)].copy()


def _engines(rna, scans=None):
    xla = XlaScanEngine(rna)
    port = TorchScanEngine(rna, device="cpu")
    for eng in (xla, port):
        if scans is not None:
            eng.setup_scans(scans)
        eng.setup_windows(rna)
    return xla, port


def _segments(rng, lens, n):
    segs = np.zeros((len(lens), n), np.uint8)
    for i, ln in enumerate(lens):
        segs[i, :ln] = np.frombuffer(b"ACGTN", np.uint8)[
            rng.integers(0, 5, ln)]
    return segs, np.asarray(lens, np.int32)


def _fwd_spec(rng, rows, lens, n_scans, rlo, rhi, m16):
    spec = {
        "seg_idx": rng.integers(0, len(lens), rows).astype(np.int32),
        "scan_idx": rng.integers(0, n_scans, rows).astype(np.int32),
        "dirn": np.ones(rows, np.int32),
        "rlens": rng.integers(rlo, rhi + 1, rows).astype(np.int32),
        "offs": np.zeros(rows, np.int32),
        "terms": np.full(rows, -1, np.int32),
        "mreals": np.full(rows, m16, np.int32),
    }
    base = np.empty(rows, np.int32)
    for r in range(rows):
        n = lens[spec["seg_idx"][r]]
        w = min(int(spec["rlens"][r]), int(n))
        spec["rlens"][r] = w
        base[r] = rng.integers(0, n - w + 1)
    spec["base"] = base
    return spec


def test_window_qp_matches_xla():
    rng = np.random.default_rng(1)
    rna = np.frombuffer(b"ACGTUN", np.uint8)[rng.integers(0, 6, 77)]
    np.testing.assert_array_equal(window.window_qp(rna), _window_qp(rna))


def _long_rows(rng, q, m, R, W):
    """Window rows for a query past 65,536 rows: offsets within 2,000 rows
    of 65,536 on both sides (up to m), mreals from below 65,536 to m + 15,
    and half the windows copying the query codes q from their offset on
    (15% mutated) -> (codes, offs, mreals)."""
    offs = rng.integers(CHUNK - 2000, min(m, CHUNK + 2000), R).astype(
        np.int32)
    mreals = np.minimum(offs + rng.integers(1, 4000, R), m + 15).astype(
        np.int32)
    mreals[::3] = m + rng.integers(0, 16, len(mreals[::3]))
    codes = rng.integers(0, 5, (R, W)).astype(np.uint8)
    for r in range(0, R, 2):
        piece = q[offs[r]:offs[r] + W].copy()
        muts = rng.random(len(piece)) < 0.15
        piece[muts] = rng.integers(0, 5, int(muts.sum()))
        codes[r, :len(piece)] = piece
    return codes, offs, mreals


@pytest.mark.parametrize("m", [143, CHUNK + 1, 68000])
@pytest.mark.parametrize("rev", [False, True])
def test_window_pass_matches_xla(rev, m):
    """Codes interface with random offs, terms, rlens and mreals; at a query
    just past 65,536 rows and at 68,000 too (K4's long form on the card),
    with offsets and mreals on both sides of 65,536."""
    rng = np.random.default_rng(21 + rev + (m > 143) * m)
    rna = _rna(rng, m)
    xla, port = _engines(rna)
    R, W = 29, 128
    codes = rng.integers(0, 5, (R, W)).astype(np.uint8)
    rlens = rng.integers(4, W + 1, R).astype(np.int32)
    offs = rng.integers(0, m // 2, R).astype(np.int32)
    terms = np.where(rng.random(R) < 0.5, -1,
                     rng.integers(5, 60, R)).astype(np.int32)
    mreals = (m + rng.integers(0, 16, R)).astype(np.int32)
    if m > CHUNK:
        q = rules.SSW_ENC[rna[::-1] if rev else rna]
        codes, offs, mreals = _long_rows(rng, q, m, R, W)
    a = np.asarray(xla.window_pass(codes, offs, terms, rlens, mreals,
                                   rev=rev))
    b = port.window_pass(codes, offs, terms, rlens, mreals, rev=rev)
    np.testing.assert_array_equal(b, a)


def test_window_pass_specs_vs_xla_and_pallas():
    """Mixed forward / reversed reads with offs, terms and mreals through
    the production specs interface: port == XLA == Pallas (interpret)."""
    from fasim_tpu.kernels.tpu import TpuScanEngine

    rng = np.random.default_rng(7)
    m = 131
    rna = _rna(rng, m)
    scans = rules.scan_list(0, 0)
    xla, port = _engines(rna, scans)
    tpu = TpuScanEngine(rna, interpret=True)
    tpu.setup_scans(scans)
    tpu.setup_windows(rna)
    segs, lens = _segments(rng, [640, 503, 640, 77], 640)
    R = 37
    spec = {
        "seg_idx": rng.integers(0, 4, R).astype(np.int32),
        "scan_idx": rng.integers(0, len(scans), R).astype(np.int32),
        "dirn": np.where(rng.random(R) < 0.5, 1, -1).astype(np.int32),
        "rlens": rng.integers(4, 120, R).astype(np.int32),
        "offs": rng.integers(0, m // 2, R).astype(np.int32),
        "terms": np.where(rng.random(R) < 0.5, -1,
                          rng.integers(5, 60, R)).astype(np.int32),
        "mreals": (m + rng.integers(0, 16, R)).astype(np.int32),
    }
    base = np.empty(R, np.int32)
    for r in range(R):
        n = lens[spec["seg_idx"][r]]
        w = min(int(spec["rlens"][r]), int(n))
        spec["rlens"][r] = w
        base[r] = (rng.integers(0, n - w + 1) if spec["dirn"][r] == 1
                   else rng.integers(w - 1, n))
    spec["base"] = base
    for rev in (False, True):
        a = np.asarray(xla.window_pass_specs(segs, lens, spec, rev=rev))
        b = tpu.window_pass_specs(segs, lens, spec, rev=rev)
        c = port.window_pass_specs(segs, lens, spec, rev=rev)
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)


@pytest.mark.parametrize("rlo,rhi", [(4, 48), (25, 64), (65, 96),
                                     (97, 128), (129, 196), (197, 256)])
def test_forward_width_classes(rlo, rhi):
    """Uniform forward specs of every width class, including rlens in
    (196, 256] (beyond the Pallas v3 kernel's phased prefix cover,
    ROADMAP.md section 3): port == XLA; port == Pallas v3 (interpret,
    small buckets) up to 196."""
    rng = np.random.default_rng(rhi)
    m = 131
    rna = _rna(rng, m)
    scans = rules.scan_list(0, 0)
    xla, port = _engines(rna, scans)
    segs, lens = _segments(rng, [512, 301, 277], 512)
    spec = _fwd_spec(rng, 11, lens, len(scans), rlo, rhi, _ru(m, 16))
    a = np.asarray(xla.window_pass_specs(segs, lens, spec, rev=False))
    c = port.window_pass_specs(segs, lens, spec, rev=False)
    np.testing.assert_array_equal(c, a)
    if rhi <= 196:
        from fasim_tpu.kernels.tpu import TpuScanEngine

        tpu = TpuScanEngine(rna, interpret=True)
        tpu.setup_scans(scans)
        tpu.setup_windows(rna)
        R = 16
        tpu._win_R = {k: R for k in tpu._win_R}
        tpu.WIN_BUCKETS = {w: (R,) + v[1:]
                           for w, v in tpu.WIN_BUCKETS.items()}
        n0 = tpu.n_v3_calls
        b = tpu.window_pass_specs(segs, lens, spec, rev=False)
        assert tpu.n_v3_calls == n0 + 1
        np.testing.assert_array_equal(c, b)


def test_reverse_terms_offs_mreals():
    """Reverse pass of real forward ends: offset rows, terminate break and
    the per-row phantom bound, for both lane layouts — against XLA and
    the golden striped-pass model."""
    rng = np.random.default_rng(97)
    m = 97
    rna = _rna(rng, m)
    xla, port = _engines(rna)
    q_idx = rules.SSW_ENC[rna]
    cases = []
    while len(cases) < 20:
        w = int(rng.integers(8, 80))
        ref = rng.integers(0, 5, w).astype(np.int32)
        best, ecol, erow, _ = kalign._sw_end_pass(
            q_idx, ref, GAP_OPEN, GAP_EXTEND, rules.SSW_MAT, 16, False, None)
        if best:
            cases.append((ref, best, ecol, erow))
    R, W = len(cases), 80
    codes = np.full((R, W), 4, np.uint8)
    offs, terms, rlens, mreals = (np.empty(R, np.int32) for _ in range(4))
    for lanes in (16, 8):
        for r, (ref, best, ecol, erow) in enumerate(cases):
            rev_ref = ref[ecol::-1]
            rlens[r] = len(rev_ref)
            codes[r, :len(rev_ref)] = rev_ref
            offs[r] = m - 1 - erow
            terms[r] = best
            mreals[r] = m + (-(erow + 1)) % lanes
        a = np.asarray(xla.window_pass(codes, offs, terms, rlens, mreals,
                                       rev=True))
        b = port.window_pass(codes, offs, terms, rlens, mreals, rev=True)
        np.testing.assert_array_equal(b, a)
        for r, (ref, best, ecol, erow) in enumerate(cases):
            rb, rc, rr, _ = kalign._sw_end_pass(
                q_idx[erow::-1], ref[ecol::-1].astype(np.int64), GAP_OPEN,
                GAP_EXTEND, rules.SSW_MAT, lanes, False, best)
            assert (b[r, 0], b[r, 1], b[r, 2] - offs[r]) == (rb, rc, rr)


def test_routing_uniform_forward_to_k3(monkeypatch):
    """Uniform forward specs go to K3 (window_fwd), all others to K4
    (window_general); the gate reads the spec columns by name."""
    calls = []
    for name in ("window_fwd", "window_general"):
        real = getattr(engine_mod, name)

        def spy(*args, _name=name, _real=real):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(engine_mod, name, spy)
    rng = np.random.default_rng(5)
    m = 60
    rna = _rna(rng, m)
    scans = rules.scan_list(0, 0)
    _, port = _engines(rna, scans)
    segs, lens = _segments(rng, [300, 200], 320)
    spec = _fwd_spec(rng, 9, lens, len(scans), 10, 120, _ru(m, 16))
    port.window_pass_specs(segs, lens, spec, rev=False)
    assert calls and set(calls) == {"window_fwd"}
    for key, val in (("offs", 1), ("terms", 7), ("mreals", m + 1),
                     ("dirn", -1)):
        calls.clear()
        bad = dict(spec)
        bad[key] = spec[key].copy()
        bad[key][3] = val
        if key == "dirn":
            bad["base"] = spec["base"] + spec["rlens"] - 1
        port.window_pass_specs(segs, lens, bad, rev=False)
        assert set(calls) == {"window_general"}, key
    calls.clear()
    port.window_pass_specs(segs, lens, spec, rev=True)
    assert set(calls) == {"window_general"}
    # K3's shape gate: a query longer than K3_MAX_M rows takes K4
    for limit, want in ((m, "window_fwd"), (m - 1, "window_general")):
        monkeypatch.setattr(engine_mod, "K3_MAX_M", limit)
        calls.clear()
        port.window_pass_specs(segs, lens, spec, rev=False)
        assert set(calls) == {want}, limit


def test_align_chain_matches_align_window_py():
    """Device fwd + device rev + host banded on the port engine == the
    golden single-window alignment."""
    from fasim_tpu_torch.scan.candidates import align_via_window_pass

    rng = np.random.default_rng(151)
    m = 151
    rna = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, m)]
    _, port = _engines(rna)
    q_idx = rules.SSW_ENC[rna]
    n_checked = 0
    for _ in range(30):
        w = int(rng.integers(10, 120))
        if rng.random() < 0.5:
            ref = rng.integers(0, 5, w).astype(np.int32)
        else:
            lo = int(rng.integers(0, m - 5))
            piece = q_idx[lo:lo + min(w, m - lo)].astype(np.int32)
            muts = rng.random(len(piece)) < 0.15
            piece[muts] = rng.integers(0, 5, muts.sum())
            ref = np.concatenate([piece, rng.integers(0, 5, w)])[:w]
        golden = kalign.align_window_py(q_idx, ref, rules.SSW_MAT)
        got = align_via_window_pass(port, q_idx, ref.astype(np.uint8),
                                    rules.SSW_MAT)
        assert got.sw_score == golden.sw_score
        if golden.sw_score:
            assert (got.ref_begin, got.ref_end, got.query_begin,
                    got.query_end, got.cigar) == (
                golden.ref_begin, golden.ref_end, golden.query_begin,
                golden.query_end, golden.cigar)
            n_checked += 1
    assert n_checked >= 8


def test_long_forms_refuse_rows_past_their_key(monkeypatch):
    """On the card the long forms key rows t < LONG_MAX_ROWS (v1's 20-bit
    row key): a query past it raises before any launch."""
    from fasim_tpu_torch.kernels import window_v1

    entries = []
    for mod in (window, window_v1):
        monkeypatch.setattr(mod, "_on_card", lambda name, codes: True)
    monkeypatch.setattr(window, "_run",
                        lambda entry, codes, *args: entries.append(entry))
    m = window.LONG_MAX_ROWS + 1
    codes = torch.zeros(2, 64, dtype=torch.uint8)
    ints = torch.zeros(2, dtype=torch.int32)
    qp = torch.zeros(3, m + 63, dtype=torch.int32)
    tab = torch.zeros(m + 63, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="window_general_long: m = "):
        window.window_general(codes, qp, ints, ints, ints, ints, m, tab)
    with pytest.raises(ValueError, match="window_v1_long: .* query rows"):
        window_v1.window_v1(codes, qp[0, :m + 15].contiguous(), ints, ints,
                            ints, ints, m, tab)
    assert entries == []


def test_window_kernels_reject_other_devices():
    meta = torch.device("meta")
    codes = torch.zeros(2, 64, dtype=torch.uint8, device=meta)
    qp = torch.zeros(3, 128, dtype=torch.int32, device=meta)
    rows = torch.zeros(2, dtype=torch.int32, device=meta)
    tab = torch.zeros(128, 8, dtype=torch.int8, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        window.window_fwd(codes, qp, tab, rows, 10, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        window.window_general(codes, qp, rows, rows, rows, rows, 10, tab)
    with pytest.raises(ValueError, match="unsupported device"):
        window.window_general_long(codes, qp, rows, rows, rows, rows, 10,
                                   tab)


@pytest.mark.parametrize("m,want", [(window.K3_MAX_M, "window_fwd"),
                                    (window.K3_MAX_M + 1, "window_general")])
def test_k3_gate_at_its_query_length(m, want, monkeypatch):
    """Uniform forward specs at the longest query K3 takes go to K3, one
    row longer to K4, whose wrapper runs them on its long form
    (window_general_long); both equal XLA."""
    calls = []
    for mod, name in ((engine_mod, want),
                      (window, "window_general_long")):
        real = getattr(mod, name)

        def spy(*args, _name=name, _real=real):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    rng = np.random.default_rng(m)
    rna = _rna(rng, m)
    scans = rules.scan_list(0, 0)
    xla, port = _engines(rna, scans)
    segs, lens = _segments(rng, [300, 200], 320)
    spec = _fwd_spec(rng, 5, lens, len(scans), 10, 40, _ru(m, 16))
    a = np.asarray(xla.window_pass_specs(segs, lens, spec, rev=False))
    c = port.window_pass_specs(segs, lens, spec, rev=False)
    np.testing.assert_array_equal(c, a)
    assert calls == [want] + (["window_general_long"] if m > window.K3_MAX_M
                              else [])


def test_score_table_matches_window_qp():
    """The score table of K3 and K4: byte c of row i is XLA's window score
    of code c on query row i, plus TABLE_BIAS, for every code a window
    holds and the ones past it (0..6) and every row incl. the phantom ones;
    byte ZERO_CODE is TABLE_BIAS (score 0) on every row.  The engine keeps
    wtab_fwd and wtab_rev in step with qwin_fwd and qwin_rev, also through
    load_state."""
    rng = np.random.default_rng(3)
    rna = np.frombuffer(b"ACGTUN", np.uint8)[rng.integers(0, 6, 101)]

    def want_of(q):
        qp = _window_qp(q)
        want = np.where(np.arange(8)[None, :] == qp[0][:, None],
                        qp[1][:, None], qp[2][:, None]) + window.TABLE_BIAS
        want[:, window.ZERO_CODE] = window.TABLE_BIAS
        return want

    want = want_of(rna)
    assert window.ZERO_CODE > 4  # no window code (SSW codes are 0..4)
    tab = window.score_table(torch.from_numpy(window.window_qp(rna)))
    assert tab.dtype == torch.int8 and tab.shape == (want.shape[0], 8)
    np.testing.assert_array_equal(tab.numpy(), want)
    port = TorchScanEngine(rna, device="cpu")
    port.setup_windows(rna)
    np.testing.assert_array_equal(port._dev["wtab_fwd"].numpy(), want)
    np.testing.assert_array_equal(port._dev["wtab_rev"].numpy(),
                                  want_of(rna[::-1]))
    other = rna[::-1].copy()
    port.load_state({"qwin_fwd": _window_qp(other),
                     "qwin_rev": _window_qp(rna)})
    np.testing.assert_array_equal(port._dev["wtab_fwd"].numpy(),
                                  want_of(other))
    np.testing.assert_array_equal(port._dev["wtab_rev"].numpy(), want)


def _prmt(a: int, b: int, sel: int) -> int:
    """PTX prmt.b32 (default mode): byte k of the result is byte (s & 7)
    of the pair (b:a), or its sign replicated when s & 8, s the k-th
    nibble of sel."""
    src = (b << 32) | a
    out = 0
    for k in range(4):
        s = (sel >> (4 * k)) & 15
        byte = (src >> (8 * (s & 7))) & 0xFF
        if s & 8:
            byte = 0xFF if byte & 0x80 else 0
        out |= byte << (8 * k)
    return out


def test_selector_unpacks_both_windows_scores():
    """Round trip of window_fwd.cu's score lookup: the selector of two
    window codes (ca, cb) = ca | (ca | 8) << 4 | cb << 8 | (cb | 8) << 12,
    applied by prmt to a row's two table words, gives window A's score
    + TABLE_BIAS sign-extended in the low int16 and window B's in the
    high one, for every pair of codes and every kind of query row."""
    rna = np.frombuffer(b"ACGTN", np.uint8).copy()  # q = 0..4, then phantom
    tab = window.score_table(torch.from_numpy(window.window_qp(rna)))
    words = tab.numpy().view(np.uint32)  # [Mp, 2]: codes 0..3, 4..7
    qp = window.window_qp(rna)
    for i in range(len(rna) + 2):
        lo, hi = int(words[i, 0]), int(words[i, 1])
        for ca in range(5):
            for cb in range(5):
                sel = ca | (ca | 8) << 4 | cb << 8 | (cb | 8) << 12
                got = _prmt(lo, hi, sel)
                halves = [((got >> sh) & 0xFFFF) for sh in (0, 16)]
                halves = [h - 0x10000 if h & 0x8000 else h for h in halves]
                want = [(qp[1, i] if c == qp[0, i] else qp[2, i])
                        + window.TABLE_BIAS for c in (ca, cb)]
                assert halves == want, (i, ca, cb)


@pytest.mark.parametrize("rlens", [
    [40, 3, 64, 32, 33, 1, 17, 50, 32, 7, 64],  # mixed, odd count
    [5, 32, 9],  # all at 32 columns
    [33, 64],  # none
])
def test_pair_order_round_trip(rlens):
    """K3's 64-column row order: a permutation that puts the rows with
    rlen <= NARROW first, each part in its original order, with their
    count."""
    rl = torch.tensor(rlens, dtype=torch.int32)
    order, n = window.pair_order(rl)
    assert order.dtype == torch.int32 and n.dtype == torch.int32
    o = order.numpy()
    narrow = [i for i, r in enumerate(rlens) if r <= window.NARROW]
    wide = [i for i, r in enumerate(rlens) if r > window.NARROW]
    assert n.tolist() == [len(narrow)]
    assert o.tolist() == narrow + wide
    assert sorted(o.tolist()) == list(range(len(rlens)))


@settings(max_examples=30, deadline=None)
@given(m=st.integers(1, 90), rows=st.integers(1, 4),
       width=st.sampled_from([64, 128]), seed=st.integers(0, 2 ** 32 - 1),
       match_run=st.booleans())
def test_window_best_fits_int16(m, rows, width, seed, match_run):
    """The bound K3's 16-bit cells rest on: a window pass's best is at most
    5 * min(rlen, m) (every cell of a path scores <= 5), so <= 1,280 for
    any query, within int16."""
    rng = np.random.default_rng(seed)
    rna = _rna(rng, m)
    q = rules.SSW_ENC[rna]
    codes = rng.integers(0, 5, (rows, width)).astype(np.uint8)
    if match_run:  # windows that copy the query score as high as it goes
        n = min(m, width)
        codes[:, :n] = q[:n]
    rlens = rng.integers(1, width + 1, rows).astype(np.int32)
    qp = torch.from_numpy(window.window_qp(rna))
    m16 = _ru(m, 16)

    def fill(v):
        return torch.full((rows,), v, dtype=torch.int32)

    ends = window.window_pass_ref(torch.from_numpy(codes), qp, fill(0),
                                  fill(-1), torch.from_numpy(rlens),
                                  fill(m16), m).numpy()
    assert (ends[:, 0] <= 5 * np.minimum(rlens, m)).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pair_order_by_offset_round_trip(seed):
    """K4's row order for each width class: a permutation with the rows of
    rlen <= K4_SHORT[W] first (their count returned), each part sorted by
    offset clamped to [0, m], rows of equal offset in their original
    order; at a query length whose key outgrows int16 too, and at one
    past 65,536 rows (the long form's), offsets past 65,535 included."""
    rng = np.random.default_rng(seed)
    rows = 41
    m = (10, 16383, 20000, 91068)[seed]
    W = window.WIDTHS[seed % 3]
    short = window.K4_SHORT[W]
    rlens = rng.integers(1, W + 1, rows).astype(np.int32)
    offs = rng.integers(-2, m + 3, rows).astype(np.int32)
    offs[:8] = offs[8:16]  # ties
    order, n = window.offset_order(torch.from_numpy(rlens),
                                   torch.from_numpy(offs), m, short)
    assert order.dtype == torch.int32 and n.dtype == torch.int32
    want = sorted(range(rows), key=lambda i: (bool(rlens[i] > short),
                                              min(max(int(offs[i]), 0), m),
                                              i))
    assert order.numpy().tolist() == want
    assert n.tolist() == [int((rlens <= short).sum())]


@pytest.mark.parametrize("m,want", [
    (window.K3_MAX_M, ("fasim_window_gen", 0)),
    (window.K3_MAX_M + 1, ("fasim_window_gen", 1))])
def test_k4_routes_by_query_length(m, want, monkeypatch):
    """K4's wrapper on the card (kernels monkeypatched): queries of up to
    K3_MAX_M rows launch the pair sweep with 16-bit row keys (wide 0) and
    count in window_general.launches, longer ones its long form (wide 1)
    and count in window_general_long.launches."""
    entries = []
    monkeypatch.setattr(window, "_on_card", lambda name, codes: True)
    monkeypatch.setattr(window, "_run", lambda entry, codes, *args:
                        entries.append((entry, args[-2])))
    for fn in (window.window_general, window.window_general_long):
        monkeypatch.setattr(fn, "launches", 0)
    rows = 6
    qp = torch.from_numpy(window.window_qp(_rna(np.random.default_rng(m),
                                                m)))
    ints = torch.zeros(rows, dtype=torch.int32)
    out = window.window_general(torch.zeros(rows, 64, dtype=torch.uint8), qp,
                                ints, ints - 1, ints + 20, ints + m, m,
                                window.score_table(qp))
    assert out.shape == (rows, 3)
    assert entries == [want]
    gen = want[1] == 0
    assert (window.window_general.launches,
            window.window_general_long.launches) == (int(gen), int(not gen))


@settings(max_examples=30, deadline=None)
@given(m=st.integers(1, 90), rows=st.integers(1, 4),
       width=st.sampled_from([64, 128]), seed=st.integers(0, 2 ** 32 - 1),
       match_run=st.booleans())
def test_window_best_fits_int16_reverse_specs(m, rows, width, seed,
                                              match_run):
    """The bound K4's 16-bit cells rest on, for reverse specs with random
    offs, terms and mreals: the best is at most 5 * min(rlen, m - off)
    (only rows off..m-1 score), so <= 1,280 for any query, and a positive
    best ends on a row in [off, m), or on _BIG when only a phantom row
    attains it."""
    rng = np.random.default_rng(seed)
    rev = _rna(rng, m)[::-1].copy()
    q = rules.SSW_ENC[rev]
    offs = rng.integers(0, m, rows).astype(np.int32)
    codes = rng.integers(0, 5, (rows, width)).astype(np.uint8)
    if match_run:  # windows that copy the query from their offset on
        for r in range(rows):
            n = min(m - offs[r], width)
            codes[r, :n] = q[offs[r]:offs[r] + n]
    rlens = rng.integers(1, width + 1, rows).astype(np.int32)
    terms = np.where(rng.random(rows) < 0.5, -1,
                     rng.integers(0, 5 * min(m, width) + 1, rows))
    mreals = m + rng.integers(0, 16, rows)
    qp = torch.from_numpy(window.window_qp(rev))
    ends = window.window_pass_ref(
        torch.from_numpy(codes), qp, *(torch.from_numpy(
            np.asarray(a, np.int32)) for a in (offs, terms, rlens, mreals)),
        m).numpy()
    assert (ends[:, 0] <= 5 * np.minimum(rlens, m - offs)).all()
    pos = ends[:, 0] > 0
    er = ends[pos, 2]
    assert (((er >= offs[pos]) & (er < m)) | (er == window._BIG)).all()


def _s16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def _pack(a: int, b: int) -> int:
    return (a & 0xFFFF) | (b & 0xFFFF) << 16


def _addmax(a: int, b: int, c: int, relu: bool = False) -> int:
    """__viaddmax_s16x2[_relu]: max(a + b, c) in each int16 half."""
    out = [max(_s16(a >> s) + _s16(b >> s), _s16(c >> s)) for s in (0, 16)]
    return _pack(*[max(v, 0) if relu else v for v in out])


def _max_relu(a: int, b: int) -> int:
    """__vimax_s16x2_relu."""
    return _pack(*[max(_s16(a >> s), _s16(b >> s), 0) for s in (0, 16)])


def _wide_key(k: int, cb: int) -> int:
    """window_pairs.cuh's wide_key: the chunk key k = (H << 16) | (0xFFFF
    - (t - cb)) as (H << 20) | (0xFFFFF - t); 0 for no key."""
    return ((k >> 16) << 20) + (0xF0000 - cb) + (k & 0xFFFF) if k else 0


def _k4_pair_model(codes, offs, mreals, terms, rlens, words, m, v1=False,
                   with_columns=False, long=False):
    """Bit-level model of window_pairs.cuh's pair of windows (A low, B high
    half), columns in order (the wavefront only reorders the cells):
    the sweep from the lower offset to the larger mreal with the other
    half on the zero-score code until its own offset, the s16x2 cell, the
    row keys (their low half 0xFFFF - row mod 2**16) and the phantom max
    (K4) or the row keys on the phantom rows too (v1: K6), each half's
    masked past its mreal, and the cut and ends reductions.  With long,
    the long form: at the first row of each later chunk of 65,536 rows (a
    keyed one: K4 real rows only) the keys fold into the running best wide
    key and start afresh, and the ends read the max of both.  -> [(best,
    end_col, end_row)] for A and B, and with with_columns each half's
    per-column [(column max, its row)] too."""
    M16, M4, TOP, MIN = 0xFFF0FFF0, 0xFFFCFFFC, 0xC000C000, 0x80008000
    W = codes.shape[1]
    s = [min(max(int(o), 0), m) for o in offs]
    r0, r1 = min(s), max(s)
    top = min(max(int(mreals[0]), int(mreals[1])), words.shape[0])
    zm = 0x7700 if s[0] < s[1] else (0x0077 if s[1] < s[0] else 0)
    sel = [int(a) | (int(a) | 8) << 4 | int(b) << 8 | (int(b) | 8) << 12
           for a, b in zip(codes[0], codes[1])]
    g, f = [M16] * W, [TOP] * W
    ka, kb, pm = [0] * W, [0] * W, [0] * W
    wa, wb = [0] * W, [0] * W  # long: the best of the earlier chunks
    cb = r0 & ~0xFFFF  # long: the chunk of ka and kb
    for i in range(r0, top):
        if long and i & 0xFFFF == 0 and i != cb and (v1 or i < m):
            for k in range(W):
                wa[k] = max(wa[k], _wide_key(ka[k], cb))
                wb[k] = max(wb[k], _wide_key(kb[k], cb))
            ka, kb, cb = [0] * W, [0] * W, i
        lo, hi = int(words[i, 0]), int(words[i, 1])
        gl, el, diag = M16, 0, M16  # column -1
        tk = (0xFFFF - i) & 0xFFFFFFFF
        for k in range(W):
            sc = _prmt(lo, hi, sel[k] | (zm if i < r1 else 0))
            el = _addmax(el, M4, gl)
            tmp = _addmax(diag, sc, el, relu=True)
            f[k] = _addmax(f[k], M4, g[k])
            hv = _max_relu(tmp, f[k])
            diag = g[k]
            gl = g[k] = _addmax(hv, M16, MIN)
            mask = (0xFFFF if i < mreals[0] else 0) \
                | (0xFFFF0000 if i < mreals[1] else 0)
            if i < m or v1:
                ka[k] = max(ka[k], _prmt(tk, hv & mask, 0x5410))
                kb[k] = max(kb[k], _prmt(tk, hv & mask, 0x7610))
            else:
                pm[k] = _max_relu(pm[k], hv & mask)
    out, columns = [], []
    for h in range(2):
        cmax, crow = [], []
        for k in range(W):
            key = kb[k] if h else ka[k]
            rmax, rrow = key >> 16, 0xFFFF - (key & 0xFFFF)
            if long:
                key = max(wb[k] if h else wa[k], _wide_key(key, cb))
                rmax, rrow = key >> 20, 0xFFFFF - (key & 0xFFFFF)
            pmax = (pm[k] >> (16 * h)) & 0xFFFF
            cmax.append(max(rmax, pmax))
            crow.append(rrow if rmax >= pmax else window._BIG)
        columns.append(list(zip(cmax, crow)))
        limit = min((c for c in range(W) if terms[h] >= 0
                     and c < rlens[h] and cmax[c] == terms[h]),
                    default=window._BIG)
        key, erow = 0, window._BIG
        for c in range(W):
            kk = cmax[c] << 8 | (255 - c)
            if c < rlens[h] and c <= limit and kk > key:
                key, erow = kk, crow[c]
        best, ecol = key >> 8, 255 - (key & 255)
        out.append((best, ecol if best > 0 else -1,
                    erow if best > 0 else m - 1))
    return (out, columns) if with_columns else out


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k4_pair_model_matches_ref(seed, long):
    """The bit-level model of a K4 pair whose halves have different
    offsets, mreals (phantom bounds, and below m too) and terms (cut or
    not) equals window_pass_ref on each half, on the engine's reverse
    score table; in both forms (the long one reads its keys through the
    wide key, with no chunk start in the sweep)."""
    rng = np.random.default_rng(100 + seed)
    m = 37
    rna = _rna(rng, m)
    port = TorchScanEngine(rna, device="cpu")
    port.setup_windows(rna)
    qp = port._dev["qwin_rev"]
    words = port._dev["wtab_rev"].numpy().view(np.uint32)
    q = rules.SSW_ENC[rna[::-1]]
    W = 20
    for trial in range(8):
        offs = rng.integers(0, m, 2).astype(np.int32)
        if trial == 0:
            offs[1] = offs[0]  # a pair that shares its start row
        codes = rng.integers(0, 5, (2, W)).astype(np.uint8)
        for h in range(2):  # copy the query from the offset on, mutated
            n = min(m - offs[h], W)
            piece = q[offs[h]:offs[h] + n].copy()
            muts = rng.random(n) < 0.2
            piece[muts] = rng.integers(0, 5, int(muts.sum()))
            codes[h, :n] = piece
        rlens = rng.integers(1, W + 1, 2).astype(np.int32)
        mreals = (m + rng.integers(-12 if trial > 3 else 0, 16, 2)
                  ).astype(np.int32)
        free = window.window_pass_ref(
            torch.from_numpy(codes), qp, torch.from_numpy(offs),
            torch.full((2,), -1, dtype=torch.int32), torch.from_numpy(rlens),
            torch.from_numpy(mreals), m).numpy()
        # terms: none, or a column max the window reaches (a real cut)
        terms = np.where(rng.random(2) < 0.3, -1,
                         np.maximum(free[:, 0] - rng.integers(0, 6, 2), 0)
                         ).astype(np.int32)
        want = window.window_pass_ref(
            torch.from_numpy(codes), qp, torch.from_numpy(offs),
            torch.from_numpy(terms), torch.from_numpy(rlens),
            torch.from_numpy(mreals), m).numpy()
        got = _k4_pair_model(codes, offs, mreals, terms, rlens, words, m,
                             long=long)
        assert [tuple(r) for r in want.tolist()] == got, (trial, offs)


@pytest.mark.parametrize("long", [False, True])
def test_k4_pair_model_phantom_bound(long):
    """A pair of one window under two phantom bounds, in both orders: the
    bit-level model keeps each half's phantom max to its own mreal, in
    both forms.  The window is found by a seeded search for one whose ends
    the phantom rows change (they can only through the terms cut, so such
    windows are rare)."""
    rng = np.random.default_rng(11)
    m, W, R = 8, 10, 20000
    rna = _rna(rng, m)
    port = TorchScanEngine(rna, device="cpu")
    port.setup_windows(rna)
    qp = port._dev["qwin_fwd"]
    words = port._dev["wtab_fwd"].numpy().view(np.uint32)
    codes = rng.integers(0, 5, (R, W)).astype(np.uint8)
    offs = rng.integers(0, 3, R).astype(np.int32)
    rlens = rng.integers(3, W + 1, R).astype(np.int32)
    terms = rng.integers(3, 30, R).astype(np.int32)
    ends = {mr: window.window_pass_ref(
        torch.from_numpy(codes), qp,
        *(torch.from_numpy(a) for a in (offs, terms, rlens)),
        torch.full((R,), mr, dtype=torch.int32), m).numpy()
        for mr in (m, m + 6)}
    hit = np.flatnonzero((ends[m] != ends[m + 6]).any(1))
    assert len(hit), "no window whose ends the phantom rows change"
    i = int(hit[0])
    for mreals in ((m + 6, m), (m, m + 6)):
        got = _k4_pair_model(codes[[i, i]], offs[[i, i]],
                             np.array(mreals, np.int32), terms[[i, i]],
                             rlens[[i, i]], words, m, long=long)
        assert got == [tuple(ends[mr][i].tolist()) for mr in mreals]



def _long_query(m: int, motif_at: tuple) -> tuple:
    """A random ACGT query of m rows (seeded by m) with one 12-base motif
    planted at each start in motif_at -> (rna, SSW codes, motif codes)."""
    rng = np.random.default_rng(m)
    rna = _rna(rng, m)
    motif = _rna(rng, 12)
    for p in motif_at:
        rna[p:p + 12] = motif
    return rna, rules.SSW_ENC[rna].astype(np.uint8), \
        rules.SSW_ENC[motif].astype(np.uint8)


def _long_pairs(m: int, W: int = 24) -> tuple:
    """Pairs of windows for the long form at query length m (65,537 or
    about 91k, forward query rows), each (codes uint8[2, W], offs, mreals,
    rlens int32[2]), and the rows (tie_lo, tie_hi) of the tie.  Pair 0
    holds the tie: window A is a motif the query holds twice, ending on
    rows tie_lo < 65,536 <= tie_hi, so its last column's max (60) is
    reached on both sides of the chunk start and the lower row must win;
    window B copies the query from 5 rows before the second copy, so its
    last column's max is first reached on row tie_hi.  The others hold
    offsets on both sides of 65,536 and at or past m, mreals past m and
    below it (and below 65,536), copies of the query (mutated) and random
    windows."""
    if m <= CHUNK + 1:  # one real row (65,536) past the chunk start
        starts = (CHUNK - 56, CHUNK - 11)
    else:
        starts = (CHUNK - 60, CHUNK + 30)
    rna, q, motif = _long_query(m, starts)
    tie = (starts[0] + 11, starts[1] + 11)
    rng = np.random.default_rng(m + 1)

    def copy(off, n):
        c = rng.integers(0, 5, W).astype(np.uint8)
        piece = q[off:off + n].copy()
        muts = rng.random(len(piece)) < 0.15
        piece[muts] = rng.integers(0, 5, int(muts.sum()))
        c[:len(piece)] = piece
        return c

    a = np.full(W, 4, np.uint8)
    a[:12] = motif
    b = np.full(W, 4, np.uint8)
    b[:17] = q[starts[1] - 5:starts[1] + 12]
    pairs = [(np.stack([a, b]), [starts[0] - 3, starts[1] - 8],
              [m + 8, m + 3] if m <= CHUNK + 1 else [CHUNK + 100, CHUNK + 120],
              [12, 17])]
    top = m + 15 if m <= CHUNK + 1 else CHUNK + 90
    for offs, mreals in (
            ((CHUNK - 6, CHUNK - 1), (top, CHUNK - 2)),
            ((CHUNK - 30, CHUNK - 30), (min(m, CHUNK + 40), CHUNK - 10)),
            ((m - 80, m - 30), (m + 5, m + 12)),
            ((m, m + 4), (m + 15, m + 9))):
        codes = np.stack([copy(o, W) for o in offs])
        if offs[0] == offs[1]:
            codes[1] = rng.integers(0, 5, W)  # a random window
        pairs.append((codes, list(offs), list(mreals),
                      list(rng.integers(W // 2, W + 1, 2))))
    return rna, [(c, *(np.asarray(v, np.int32) for v in rest))
                 for c, *rest in pairs], tie


def _long_terms(codes, offs, mreals, rlens, qp, m, rng):
    """Terms for a pair: none, or a column max the window reaches (a real
    cut), from its ends without terms."""
    free = window.window_pass_ref(
        torch.from_numpy(codes), qp, torch.from_numpy(offs),
        torch.full((2,), -1, dtype=torch.int32), torch.from_numpy(rlens),
        torch.from_numpy(mreals), m).numpy()
    return np.where(rng.random(2) < 0.4, -1,
                    np.maximum(free[:, 0] - rng.integers(0, 6, 2), 0)
                    ).astype(np.int32)


@pytest.mark.parametrize("m", [CHUNK + 1, 91068])
def test_k4_pair_model_long_matches_ref(m):
    """The long form's bit-level model equals window_pass_ref at a query
    just past 65,536 rows and at about 91k (KCNQ1OT1's length), on pairs
    whose sweeps cross the chunk start at 65,536 or start past it: a tie
    across it, where the lower row wins, a column max first reached past
    it, offsets on both sides of it and at m, terms that cut or not,
    mreals past m and below 65,536.  The 16-bit form, whose row keys wrap
    there, gets the tie's end row wrong."""
    rna, pairs, tie = _long_pairs(m)
    qp = torch.from_numpy(window.window_qp(rna))
    words = window.score_table(qp).numpy().view(np.uint32)
    rng = np.random.default_rng(m + 2)
    for n, (codes, offs, mreals, rlens) in enumerate(pairs):
        terms = np.full(2, -1, np.int32) if n == 0 else \
            _long_terms(codes, offs, mreals, rlens, qp, m, rng)
        want = window.window_pass_ref(
            torch.from_numpy(codes), qp, *(torch.from_numpy(a) for a in (
                offs, terms, rlens, mreals)), m).numpy()
        got = _k4_pair_model(codes, offs, mreals, terms, rlens, words, m,
                             long=True)
        assert [tuple(r) for r in want.tolist()] == got, (n, offs)
        if n == 0:
            assert got == [(60, 11, tie[0]), (85, 16, tie[1])]
            assert _k4_pair_model(codes, offs, mreals, terms, rlens, words,
                                  m)[0] != got[0]
