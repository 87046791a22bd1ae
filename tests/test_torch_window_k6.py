"""K6's kernel (csrc/window_v1.cu: fasim_window_v1, the pair sweep of
csrc/window_pairs.cuh with v1's statistics) on the CPU: a bit-level model
of its pair of windows against K6's plain chain (`window_keys_ref` ->
`decode_key` -> `ends_from_stats`, itself held against the Pallas kernel
and XlaScanEngine in tests/test_torch_window_v1.py), the phantom rows that
tell K6's statistics from K4's, and the wrapper's routing and refusals.
Every output is an integer array: tolerance 0.  The CUDA kernel is held
against the same plain chain on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from test_torch_window import CHUNK, _k4_pair_model, _long_pairs, _long_terms

from fasim_tpu_torch.kernels import window, window_v1
from fasim_tpu_torch.kernels.engine import TorchScanEngine


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rna(rng, m):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m)].copy()


def _engine(rng, m):
    rna = _rna(rng, m)
    port = TorchScanEngine(rna, device="cpu")
    port.setup_windows(rna)
    return port


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in arrays]


def _plain(codes, qc, offs, terms, rlens, mreals, m):
    """K6's plain chain: (ends int32[n, 3], column max and its first row,
    each int32[n, W])."""
    c = torch.from_numpy(codes)
    o, t, r, mr = _t(offs, terms, rlens, mreals)
    mx, mrow = window_v1.decode_key(window_v1.window_keys_ref(c, qc, o, mr,
                                                              m))
    ends = window_v1.ends_from_stats(mx, mrow, t, r, m)
    return ends.numpy(), mx.numpy(), mrow.numpy()


def _columns_agree(columns, mx, mrow) -> bool:
    """The model's per-column (max, row) equal the plain keys' on every
    column whose max is > 0 (a column whose max is 0 never reaches the
    ends, so the kernel keeps no counterpart of v1's keys there)."""
    return all(columns[h][c] == (int(mx[h, c]), int(mrow[h, c]))
               for h in range(2) for c in range(mx.shape[1]) if mx[h, c] > 0)


def _query_windows(rng, q, offs, W, m):
    """Two windows of W codes, each copying the query from its offset on
    (mutated), random past it."""
    codes = rng.integers(0, 5, (2, W)).astype(np.uint8)
    for h in range(2):
        n = max(min(m - int(offs[h]), W), 0)
        piece = q[offs[h]:offs[h] + n].copy()
        muts = rng.random(n) < 0.2
        piece[muts] = rng.integers(0, 5, int(muts.sum()))
        codes[h, :n] = piece
    return codes


@pytest.mark.parametrize("long", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k6_pair_model_matches_plain_chain(seed, long):
    """The bit-level model of a K6 pair equals the plain chain on each
    half, ends and column statistics, on the engine's score table (forward
    for even seeds, reverse for odd): shared and mismatched offsets within
    the pair, mreals below and above m, terms that cut or do not, an offset
    at or past the window's last keyed row (mreal) and one past the
    query's last row; in both forms (no chunk start in these sweeps)."""
    rng = np.random.default_rng(300 + seed)
    m, W = 37, 20
    port = _engine(rng, m)
    rev = bool(seed % 2)
    words = port._dev["wtab_rev" if rev else "wtab_fwd"].numpy().view(
        np.uint32)
    qc = port._qcodes(rev)
    q = qc.numpy()[:m]
    for trial in range(8):
        offs = rng.integers(0, m, 2)
        if trial == 0:
            offs[1] = offs[0]  # a pair that shares its start row
        mreals = m + rng.integers(-12 if trial > 3 else 0, 16, 2)
        if trial == 6:  # A starts at or past its last keyed row
            offs[0] = mreals[0] + rng.integers(0, 4)
        if trial == 7:  # B starts past the query
            offs[1] = m + 3
        codes = _query_windows(rng, q, offs, W, m)
        rlens = rng.integers(1, W + 1, 2)
        free = _plain(codes, qc, offs, [-1, -1], rlens, mreals, m)[0]
        # terms: none, or a column max the window reaches (a real cut)
        terms = np.where(rng.random(2) < 0.3, -1,
                         np.maximum(free[:, 0] - rng.integers(0, 6, 2), 0))
        want, mx, mrow = _plain(codes, qc, offs, terms, rlens, mreals, m)
        got, columns = _k4_pair_model(codes, offs, mreals, terms, rlens,
                                      words, m, v1=True, with_columns=True,
                                      long=long)
        assert [tuple(r) for r in want.tolist()] == got, (trial, offs)
        assert _columns_agree(columns, mx, mrow), (trial, offs)


@pytest.mark.parametrize("m", [CHUNK + 1, 91068])
def test_k6_pair_model_long_matches_plain_chain(m):
    """The long form's bit-level model with v1's statistics equals the
    plain chain (one call over every pair), ends and column statistics, at
    a query just past 65,536 rows and at about 91k, on the pairs of
    tests/test_torch_window.py's _long_pairs: a tie across the chunk start
    at 65,536 (the lower row wins), a column max first reached past it,
    offsets on both sides of it and at m, terms, mreals past m (keyed
    phantom rows past 65,536) and below 65,536."""
    rna, pairs, tie = _long_pairs(m)
    qp = torch.from_numpy(window.window_qp(rna))
    qc = qp[0, :window_v1.query_rows(m)].contiguous()
    words = window.score_table(qp).numpy().view(np.uint32)
    rng = np.random.default_rng(m + 2)
    terms = [np.full(2, -1, np.int32)] + [
        _long_terms(codes, offs, mreals, rlens, qp, m, rng)
        for codes, offs, mreals, rlens in pairs[1:]]
    cols = [np.concatenate(c) for c in zip(*pairs)]
    want, mx, mrow = _plain(cols[0], qc, cols[1], np.concatenate(terms),
                            cols[3], cols[2], m)
    for n, (codes, offs, mreals, rlens) in enumerate(pairs):
        got, columns = _k4_pair_model(codes, offs, mreals, terms[n], rlens,
                                      words, m, v1=True, with_columns=True,
                                      long=True)
        h = slice(2 * n, 2 * n + 2)
        assert [tuple(r) for r in want[h].tolist()] == got, (n, offs)
        assert _columns_agree(columns, mx[h], mrow[h]), (n, offs)
        if n == 0:
            assert got == [(60, 11, tie[0]), (85, 16, tie[1])]


def test_k6_phantom_rows_tell_k4_apart():
    """A seeded search for a window whose phantom rows change its ends
    through the terms cut and one of whose columns attains its max only on
    a phantom row.  On that window, in a pair with itself under two
    phantom bounds (both orders), K6's model equals the plain chain, ends
    and column statistics; the model with K4's phantom handling (a packed
    max, end row kBig) fails on that column's row.  Its ends agree all the
    same: a phantom row scores 0, so its H is at most a value of the
    column to its left or its own earlier rows, and an earlier column
    attains any phantom-only maximum on a real row first.  So no end row
    is a phantom row under either contract, and the contracts differ only
    in the column statistics that the kernels reduce away."""
    rng = np.random.default_rng(11)
    m, W, R = 8, 10, 20000
    port = _engine(rng, m)
    qc = port._qcodes(False)
    words = port._dev["wtab_fwd"].numpy().view(np.uint32)
    codes = rng.integers(0, 5, (R, W)).astype(np.uint8)
    offs = rng.integers(0, 3, R)
    rlens = rng.integers(3, W + 1, R)
    terms = rng.integers(3, 30, R)
    runs = {mr: _plain(codes, qc, offs, terms, rlens, np.full(R, mr), m)
            for mr in (m, m + 6)}
    ends, mx, mrow = runs[m + 6]
    phantom = ((mx > 0) & (mrow >= m)
               & (np.arange(W)[None, :] < rlens[:, None])).any(1)
    hit = np.flatnonzero((runs[m][0] != ends).any(1) & phantom)
    assert len(hit), "no window with a phantom-row column that the cut uses"
    i = int(hit[0])
    c2, o2, t2, r2 = (a[[i, i]] for a in (codes, offs, terms, rlens))
    for mreals in ((m + 6, m), (m, m + 6)):
        mr2 = np.array(mreals)
        want, cmx, crow = _plain(c2, qc, o2, t2, r2, mr2, m)
        got, columns = _k4_pair_model(c2, o2, mr2, t2, r2, words, m, v1=True,
                                      with_columns=True)
        assert [tuple(r) for r in want.tolist()] == got
        assert _columns_agree(columns, cmx, crow)
        k4, k4_columns = _k4_pair_model(c2, o2, mr2, t2, r2, words, m,
                                        with_columns=True)
        assert not _columns_agree(k4_columns, cmx, crow)
        assert k4 == got
    assert (ends[ends[:, 0] > 0, 2] < m).all()


@pytest.mark.parametrize("rev", [False, True])
def test_v1_ends_equal_k4_ends(rev):
    """K6's plain chain and K4's plain version give the same ends on
    random windows (shared and distinct offsets, terms near the best,
    mreals m - 8 .. m + 15): no end row is a phantom row (see
    test_k6_phantom_rows_tell_k4_apart)."""
    rng = np.random.default_rng(41 + rev)
    m, W, R = 23, 40, 3000
    port = _engine(rng, m)
    qc = port._qcodes(rev)
    qp = port._dev["qwin_rev" if rev else "qwin_fwd"]
    codes = rng.integers(0, 5, (R, W)).astype(np.uint8)
    q = qc.numpy()[:m]
    offs = rng.integers(0, m, R)
    for r in range(0, R, 2):  # half the windows copy the query, mutated
        codes[r] = _query_windows(rng, q, offs[[r, r]], W, m)[0]
    rlens = rng.integers(1, W + 1, R)
    mreals = m + rng.integers(-8, 16, R)
    free = _plain(codes, qc, offs, np.full(R, -1), rlens, mreals, m)[0]
    terms = np.where(rng.random(R) < 0.5, -1,
                     np.maximum(free[:, 0] - rng.integers(0, 3, R), 0))
    got = _plain(codes, qc, offs, terms, rlens, mreals, m)[0]
    want = window.window_pass_ref(torch.from_numpy(codes), qp,
                                  *_t(offs, terms, rlens, mreals), m)
    np.testing.assert_array_equal(got, want.numpy())
    assert (got[got[:, 0] > 0, 2] < m).all()


def _on_card_stubs(monkeypatch):
    """Make window_v1's wrappers take CPU tensors as the card's and record
    the kernel entries they launch (through window.py's launcher of the
    pair sweep) with their form (wide), with their launch counts at 0."""
    entries = []
    monkeypatch.setattr(window_v1, "_on_card", lambda name, codes: True)
    monkeypatch.setattr(window, "_run", lambda entry, codes, *args:
                        entries.append((entry, args[-2])))
    for fn in (window_v1.window_v1, window_v1.window_v1_long):
        monkeypatch.setattr(fn, "launches", 0)
    return entries


# the longest query whose rows query_rows(m) fit K6's 16-bit row keys
K6_LAST_M = window_v1.K6_MAX_NQ - 15


@pytest.mark.parametrize("m,top,want", [
    (100, 115, 0),
    (K6_LAST_M, K6_LAST_M + 15, 0),
    (K6_LAST_M + 1, K6_LAST_M + 1, 1),
    (K6_LAST_M + 1, window_v1.K6_MAX_NQ + 1, 1),
])
def test_k6_routes_by_keyed_rows(m, top, want, monkeypatch):
    """K6's wrapper on the card (kernels monkeypatched) routes by shape:
    while the query rows nq = query_rows(m), which bound every keyed row t
    < min(mreal, nq), fit K6_MAX_NQ it launches K6's kernel with 16-bit row
    keys (wide 0), counted in window_v1.launches; one query row longer, its
    long form (wide 1), counted in window_v1_long.launches, whatever the
    largest mreal (nothing is read back from the card)."""
    entries = _on_card_stubs(monkeypatch)
    rng = np.random.default_rng(m)
    rna = _rna(rng, m)
    qp = torch.from_numpy(window.window_qp(rna))
    qc = qp[0, :window_v1.query_rows(m)].contiguous()
    tab = window.score_table(qp)
    rows = 5
    mreals = np.full(rows, m)
    mreals[2] = top
    ints = torch.zeros(rows, dtype=torch.int32)
    out = window_v1.window_v1(torch.zeros(rows, 64, dtype=torch.uint8), qc,
                              ints, ints - 1, ints + 20, *_t(mreals), m, tab)
    assert out.shape == (rows, 3)
    assert entries == [("fasim_window_v1", want)]
    assert (window_v1.window_v1.launches,
            window_v1.window_v1_long.launches) == (1 - want, want)


def test_window_v1_rejects(monkeypatch):
    """Devices other than cpu and cuda, and on the card other dtypes,
    widths, lengths and a table shorter than the query rows, raise before
    any launch."""
    meta = torch.device("meta")
    codes = torch.zeros(2, 64, dtype=torch.uint8, device=meta)
    ints = torch.zeros(2, dtype=torch.int32, device=meta)
    qc = torch.zeros(128, dtype=torch.int32, device=meta)
    tab = torch.zeros(128, 8, dtype=torch.int8, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        window_v1.window_v1(codes, qc, ints, ints, ints, ints, 10, tab)
    entries = _on_card_stubs(monkeypatch)
    codes = torch.zeros(2, 64, dtype=torch.uint8)
    ints = torch.zeros(2, dtype=torch.int32)
    qc = torch.zeros(128, dtype=torch.int32)
    tab = torch.zeros(128, 8, dtype=torch.int8)
    bad = [
        ((codes[:, :60].contiguous(), qc, ints, ints, ints, ints, 10, tab),
         "codes"),
        ((codes.int(), qc, ints, ints, ints, ints, 10, tab), "codes"),
        ((codes, qc.long(), ints, ints, ints, ints, 10, tab), "qc"),
        ((codes, qc, ints.long(), ints, ints, ints, 10, tab), "offs"),
        ((codes, qc, ints, ints[:1], ints, ints, 10, tab), "terms"),
        ((codes, qc, ints, ints, ints, ints, 10, tab[:, :4].contiguous()),
         "tab"),
        ((codes, qc, ints, ints, ints, ints, 10, tab[:100]), "tab"),
        ((codes, qc, ints, ints, ints, ints, 10, tab.int()), "tab"),
        ((codes, qc[:10], ints, ints, ints, ints, 10, tab), "query rows"),
    ]
    for args, what in bad:
        with pytest.raises(ValueError, match=what):
            window_v1.window_v1(*args)
    assert entries == []
    assert window_v1.window_v1.launches == 0
