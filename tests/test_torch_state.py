"""TorchScanEngine state: the tables it builds equal the JAX engines'
tables, `load_state` round-trips, and an engine loaded with a JAX
engine's tables gives the JAX engine's results (tolerance 0)."""

import numpy as np
import pytest
import torch

from fasim_tpu import rules
from fasim_tpu.kernels.tpu import TpuScanEngine
from fasim_tpu.kernels.xla import XlaScanEngine
from fasim_tpu_torch.kernels.engine import TorchScanEngine


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rna(seed, m, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    return np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), m)].copy()


def _jax_tables(rna, scans) -> dict:
    """The same tables as numpy arrays from the JAX engines: the XLA
    engine's numpy scan LUTs and window rows, the Pallas engine's scan
    rows (built on the CPU; nothing is launched)."""
    xla = XlaScanEngine(rna)
    xla.setup_scans(scans)
    xla.setup_windows(rna)
    tpu = TpuScanEngine(rna, interpret=True)
    tpu.setup_scans(scans)
    lut_s, lut_t, is_tr = xla._scan_luts
    lut6_s, lut6_t, istr = (np.asarray(a) for a in tpu._scan_luts6)
    return {"lut_s": lut_s, "lut_t": lut_t, "is_tr": is_tr,
            "lut6_s": lut6_s, "lut6_t": lut6_t, "istr": istr,
            "qp2_ssw": np.asarray(tpu.qp2_ssw),
            "qp2_thresh": np.asarray(tpu.qp2_thresh),
            "qprops_ssw": np.asarray(tpu.qprops_ssw),
            "qprops_thresh": np.asarray(tpu.qprops_thresh),
            "qwin_fwd": np.asarray(xla.qwin_fwd),
            "qwin_rev": np.asarray(xla.qwin_rev)}


def _port(rna, scans) -> TorchScanEngine:
    eng = TorchScanEngine(rna, device="cpu")
    eng.setup_scans(scans)
    eng.setup_windows(rna)
    return eng


@pytest.mark.parametrize("alphabet", [b"ACGT", b"ACGTUNacgu"])
def test_own_tables_equal_jax_tables(alphabet):
    rna = _rna(3, 75, alphabet)
    scans = rules.scan_list(0, 0)
    want = _jax_tables(rna, scans)
    got = _port(rna, scans).state()
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


def test_load_state_round_trip():
    rna = _rna(5, 90)
    scans = rules.scan_list(0, 0)[:20]
    a = _port(rna, scans)
    b = TorchScanEngine(rna, device="cpu")
    b.load_state(a.state())
    for key, arr in a.state().items():
        np.testing.assert_array_equal(b.state()[key], arr, err_msg=key)
    rng = np.random.default_rng(8)
    segs = np.zeros((2, 256), np.uint8)
    segs[0, :240] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 240)]
    segs[1, :100] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 100)]
    lens = np.array([240, 100], np.int32)
    for x, y in zip(a.scan_segments(segs, lens), b.scan_segments(segs, lens)):
        assert torch.equal(x, y)


def test_scan_tables_follow_qp2_through_load_state():
    """K1's score-class tables (`scan_table`, device only, not in
    `state()`) are rebuilt whenever qp2_ssw / qp2_thresh are set: the same
    after `load_state` of an engine's state, and built from the JAX
    engine's rows when loaded with those (a U and N query)."""
    from fasim_tpu_torch.kernels.scan import scan_table

    rna = _rna(9, 83, b"ACGTUN")
    scans = rules.scan_list(0, 0)[:12]
    a = _port(rna, scans)
    b = TorchScanEngine(rna, device="cpu")
    b.load_state(a.state())
    c = TorchScanEngine(_rna(10, 83), device="cpu")
    jax = _jax_tables(rna, scans)
    c.load_state(jax)
    for alpha in ("ssw", "thresh"):
        key = f"stab_{alpha}"
        assert key not in a.state()
        want = scan_table(torch.from_numpy(jax[f"qp2_{alpha}"].copy()),
                          alpha == "thresh")
        for eng in (a, b, c):
            got = eng._dev[key]
            assert got.thresh_alphabet == want.thresh_alphabet, key
            assert torch.equal(got.data, want.data), key


def test_codes_tables_follow_qprops_through_load_state():
    """K5's score-class tables (`scan_codes_table`, device only, not in
    `state()`) are rebuilt whenever qprops_ssw / qprops_thresh are set: an
    engine loaded with the JAX engine's qprops (a U and N query) holds the
    tables a fresh engine builds and gives its K5 output."""
    from fasim_tpu_torch.kernels.scan_codes import scan_codes_table
    from fasim_tpu_torch.rules import SSW_ENC, THRESH_ENC

    rna = _rna(13, 91, b"ACGTUN")
    fresh = TorchScanEngine(rna, device="cpu")
    loaded = TorchScanEngine(_rna(14, 91), device="cpu")
    jax = _jax_tables(rna, rules.scan_list(0, 0)[:4])
    loaded.load_state({k: jax[k] for k in ("qprops_ssw", "qprops_thresh")})
    seg = _rna(15, 3 * 150, b"ACGTUNa").reshape(1, 3, 150)
    for alpha, enc in (("ssw", SSW_ENC), ("thresh", THRESH_ENC)):
        key = f"ctab_{alpha}"
        assert key not in loaded.state()
        want = scan_codes_table(
            torch.from_numpy(jax[f"qprops_{alpha}"].copy()), alpha)
        for eng in (fresh, loaded):
            assert eng._dev[key].alphabet == alpha
            assert torch.equal(eng._dev[key].data, want.data), key
        codes = enc[seg]
        np.testing.assert_array_equal(loaded.colmax_batch(codes, alpha),
                                      fresh.colmax_batch(codes, alpha))


def test_engine_on_jax_state_equals_xla():
    """Both packages driven from identical state: the port engine loaded
    with the JAX tables reproduces XlaScanEngine on scans and windows."""
    rng = np.random.default_rng(11)
    rna = _rna(11, 70)
    scans = rules.scan_list(0, 0)
    xla = XlaScanEngine(rna)
    xla.setup_scans(scans)
    xla.setup_windows(rna)
    port = TorchScanEngine(rna, device="cpu")
    port.load_state(_jax_tables(rna, scans))
    segs = np.zeros((2, 384), np.uint8)
    lens = np.array([384, 211], np.int32)
    for i, n in enumerate(lens):
        segs[i, :n] = np.frombuffer(b"ACGTN", np.uint8)[
            rng.integers(0, 5, n)]
    thresh_x, cm_x = xla.scan_segments(segs, lens)
    thresh_p, cm_p = port.scan_segments(segs, lens)
    np.testing.assert_array_equal(thresh_p.numpy(), thresh_x)
    np.testing.assert_array_equal(cm_p.numpy(), cm_x)
    R = 15
    codes = rng.integers(0, 5, (R, 64)).astype(np.uint8)
    meta = (np.zeros(R, np.int32), np.full(R, -1, np.int32),
            rng.integers(4, 65, R).astype(np.int32),
            np.full(R, 80, np.int32))
    np.testing.assert_array_equal(
        port.window_pass(codes, *meta, rev=False),
        np.asarray(xla.window_pass(codes, *meta, rev=False)))


def test_engine_on_jax_v1_state_equals_tpu_switch_paths(monkeypatch):
    """The port loaded from the tables of a TpuScanEngine set up under
    FASIM_SCAN16=1 FASIM_WIN_V1=1, its window tables given as that
    engine's v1 query codes, reproduces that engine: the int16 scan
    passes (interpret mode) and the v1 window ends."""
    monkeypatch.setenv("FASIM_SCAN16", "1")
    monkeypatch.setenv("FASIM_WIN_V1", "1")
    rng = np.random.default_rng(12)
    rna = _rna(12, 70)
    scans = rules.scan_list(0, 0)
    tpu = TpuScanEngine(rna, interpret=True)
    tpu.setup_scans(scans)
    tpu.setup_windows(rna)
    assert tpu.scan16 and not tpu.win_v2
    tpu.win_rows = 8
    tables = _jax_tables(rna, scans)
    own_rows = {k: tables[k] for k in ("qwin_fwd", "qwin_rev")}
    for key in own_rows:
        tables[key] = np.asarray(getattr(tpu, key))[:, 0, :].reshape(-1)
    port = TorchScanEngine(rna, device="cpu")
    port.setup_windows(rna)
    port.load_state(tables)
    assert port.scan16 and port.win_v1
    for key, arr in own_rows.items():
        np.testing.assert_array_equal(port.state()[key], arr, err_msg=key)
    segs = np.zeros((2, 256), np.uint8)
    lens = np.array([256, 190], np.int32)
    for i, n in enumerate(lens):
        segs[i, :n] = np.frombuffer(b"ACGTN", np.uint8)[
            rng.integers(0, 5, n)]
    for got, want in zip(port.scan_segments(segs, lens),
                         tpu.scan_segments(segs, lens)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    R, W, m = 11, 128, len(rna)
    codes = rng.integers(0, 5, (R, W)).astype(np.uint8)
    meta = (rng.integers(0, m // 2, R).astype(np.int32),
            np.where(rng.random(R) < 0.5, -1,
                     rng.integers(5, 40, R)).astype(np.int32),
            rng.integers(4, W + 1, R).astype(np.int32),
            (m + rng.integers(0, 16, R)).astype(np.int32))
    for rev in (False, True):
        np.testing.assert_array_equal(
            port.window_pass(codes, *meta, rev=rev),
            tpu.window_pass(codes, *meta, rev=rev))


def test_load_state_rejects_mismatched_tables():
    rna = _rna(2, 40)
    eng = _port(rna, rules.scan_list(0, 0))
    state = eng.state()
    with pytest.raises(KeyError):
        eng.load_state({"matq_ssw": state["qp2_ssw"]})
    with pytest.raises(ValueError, match="qp2_ssw"):
        eng.load_state({"qp2_ssw": state["qp2_ssw"][:, :-1]})
    with pytest.raises(ValueError, match="lut6_s"):
        eng.load_state({"lut_s": state["lut_s"],
                        "lut6_s": state["lut6_s"][:-1]})
