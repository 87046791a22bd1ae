"""K5 (the v1 scan over prebuilt code rows) through TorchScanEngine on the
CPU, i.e. the kernel's plain version `scan_codes_colmax_ref`, against the
JAX package: `XlaScanEngine` (exact everywhere), the NumPy golden
`numpy_engine`, and the tables of a `TpuScanEngine` built on the CPU.

Every output is an integer array of an exact DP: the tolerance is 0.
Only real columns are compared: the JAX engines score the pad code
differently from each other (tpu.py as a mismatch, xla.py as 0), and pads
trail the real columns, so they never change one.  The CUDA kernel is
held against the same plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from fasim_tpu import rules as jax_rules
from fasim_tpu.kernels.batch_np import numpy_engine as jax_numpy_engine
from fasim_tpu.kernels.tpu import TpuScanEngine
from fasim_tpu.kernels.xla import XlaScanEngine
from fasim_tpu_torch import rules
from fasim_tpu_torch.config import BYTE_SAT
from fasim_tpu_torch.kernels import scan_codes
from fasim_tpu_torch.kernels.engine import TorchScanEngine


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # six xdist workers share the box
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _seq(rng, n, alphabet=b"ACGT"):
    return np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), n)].copy()


GA = np.frombuffer(b"GA" * 64, np.uint8)


def _sat_rna():
    """A 64-nt query equal to scan 0's transform of GA repeats: a GA run
    in a segment then scores 5 per base in transform 0, past BYTE_SAT."""
    sc = rules.scan_list(0, 0)[0]
    return rules.transfer_lut(sc["strand"], sc["para"], sc["rule"])[GA[:64]]


CASES = ["random", "ragged", "impure", "saturating"]


def _case(name, which):
    """(rna, codes int32[S, T, N], real lengths int[S]) for one case."""
    rng = np.random.default_rng(2 * CASES.index(name) + (which == "ssw"))
    enc = rules.SSW_ENC if which == "ssw" else rules.THRESH_ENC
    pad = scan_codes.PAD_CODE[which]
    if name == "random":
        rna, lens, alpha = _seq(rng, 61), [200, 200], b"ACGT"
    elif name == "ragged":
        rna, lens, alpha = _seq(rng, 40), [256, 131, 7], b"ACGT"
    elif name == "impure":
        rna, lens, alpha = _seq(rng, 50, b"ACGTUN"), [180, 97], b"ACGTUNacg"
    else:  # saturating: GA-rich query and rows, maxima past BYTE_SAT
        rna, lens, alpha = GA[:64].copy(), [160, 150], b"GA"
    T = 6
    codes = np.full((len(lens), T, max(lens)), pad, np.int32)
    for s, n in enumerate(lens):
        for t in range(T):
            codes[s, t, :n] = enc[_seq(rng, n, alpha)]
    if name == "saturating":
        codes[:, 0, 20:148] = enc[GA]
    return rna, codes, np.asarray(lens)


def _real(arr, lens):
    return [arr[s, :, :n] for s, n in enumerate(lens)]


@pytest.mark.parametrize("which", ["ssw", "thresh"])
@pytest.mark.parametrize("name", CASES)
def test_colmax_batch_matches_xla(name, which):
    rna, codes, lens = _case(name, which)
    want = XlaScanEngine(rna).colmax_batch(codes, which)
    got = TorchScanEngine(rna, device="cpu").colmax_batch(codes, which)
    assert got.dtype == np.int32 and got.shape == codes.shape
    for g, w in zip(_real(got, lens), _real(want, lens)):
        np.testing.assert_array_equal(g, w)
    if name == "saturating":
        # unclamped int32: values past the byte range come out exactly
        assert got.max() >= BYTE_SAT and got.max() > 255


@pytest.mark.parametrize("which", ["ssw", "thresh"])
@pytest.mark.parametrize("name", ["random", "impure", "saturating"])
def test_max_batch_matches_xla(name, which):
    rna, codes, lens = _case(name, which)
    codes = codes[:, :, :int(lens.min())]  # no pad columns
    want = XlaScanEngine(rna).max_batch(codes, which)
    got = TorchScanEngine(rna, device="cpu").max_batch(codes, which)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["pure", "impure", "saturating"])
def test_call_matches_numpy_engine_and_xla(kind):
    """The numpy_engine contract on one segment's 8 transformed strings:
    (thresh, byte-broken colmax) equal to the golden and the XLA engine."""
    rng = np.random.default_rng({"pure": 1, "impure": 2,
                                 "saturating": 3}[kind])
    if kind == "pure":
        rna, seg = _seq(rng, 48), _seq(rng, 230)
    elif kind == "impure":
        rna, seg = _seq(rng, 45, b"ACGTUN"), _seq(rng, 200, b"ACGTNacgt")
    else:
        rna = _sat_rna()
        seg = np.concatenate([_seq(rng, 40), GA, _seq(rng, 30)])
    seq2 = [rules.make_scan_strings(seg, s)[0]
            for s in rules.scan_list(0, 0)[:8]]
    jseq2 = [jax_rules.make_scan_strings(seg, s)[0]
             for s in jax_rules.scan_list(0, 0)[:8]]
    for a, b in zip(seq2, jseq2):
        np.testing.assert_array_equal(a, b)
    thresh, colmax = TorchScanEngine(rna, device="cpu")(rna, seq2)
    assert thresh.dtype == np.int32 and colmax.dtype == np.int32
    for ref in (jax_numpy_engine, XlaScanEngine(rna)):
        t_ref, c_ref = ref(rna, jseq2)
        np.testing.assert_array_equal(thresh, t_ref)
        np.testing.assert_array_equal(colmax, c_ref)
    if kind == "saturating":
        assert thresh.max() >= BYTE_SAT
        assert (colmax == 0).any() and colmax.max() < BYTE_SAT


def _segments(rng, lens, n, alphabet):
    segs = np.zeros((len(lens), n), np.uint8)
    for i, ln in enumerate(lens):
        segs[i, :ln] = _seq(rng, ln, alphabet)
    return segs, np.asarray(lens, np.int32)


@pytest.mark.parametrize("kind", ["pure", "impure", "saturating"])
def test_scan_segments_v1_matches_v2_and_xla(kind):
    """TorchScanEngine(use_v2=False) (code rows built by the LUT gathers,
    then K5; fused for pure input) == use_v2=True (K1) ==
    XlaScanEngine.scan_segments, pad columns included; the full_prefix
    rerun returns the same thresholds."""
    rng = np.random.default_rng({"pure": 4, "impure": 5,
                                 "saturating": 6}[kind])
    if kind == "saturating":
        rna = _sat_rna()
        segs, lens = _segments(rng, [250, 190], 256, b"ACGT")
        segs[0, 60:188] = GA
    else:
        rna = _seq(rng, 57, b"ACGT" if kind == "pure" else b"ACGTU")
        segs, lens = _segments(rng, [256, 101, 230], 256,
                               b"ACGT" if kind == "pure" else b"ACGTNa")
    scans = rules.scan_list(0, 0)[:8]
    xla = XlaScanEngine(rna)
    xla.setup_scans(jax_rules.scan_list(0, 0)[:8])
    v1 = TorchScanEngine(rna, device="cpu", use_v2=False)
    v2 = TorchScanEngine(rna, device="cpu")
    for eng in (v1, v2):
        eng.setup_scans(scans)
    assert v1.query_pure == (kind != "impure")
    tx, cx = xla.scan_segments(segs, lens)
    t1, c1 = v1.scan_segments(segs, lens)
    t2, c2 = v2.scan_segments(segs, lens)
    for t, c in ((t1, c1), (t2, c2)):
        np.testing.assert_array_equal(t.numpy(), tx)
        np.testing.assert_array_equal(c.numpy(), cx)
    if kind == "saturating":
        assert tx.max() >= BYTE_SAT
        tf, _ = v1.scan_segments(segs, lens, full_prefix=True)
        np.testing.assert_array_equal(tf.numpy(), tx)


def test_load_state_qprops_from_tpu_engine():
    """qprops tables of a JAX TpuScanEngine (built on the CPU; nothing is
    launched) load into the port engine and give the same maxima as the
    port's own tables."""
    rng = np.random.default_rng(8)
    rna = _seq(rng, 70, b"ACGTUN")
    tpu = TpuScanEngine(rna, interpret=True)
    own = TorchScanEngine(rna, device="cpu")
    loaded = TorchScanEngine(rna, device="cpu")
    loaded.load_state({"qprops_ssw": np.asarray(tpu.qprops_ssw),
                       "qprops_thresh": np.asarray(tpu.qprops_thresh)})
    for key in ("qprops_ssw", "qprops_thresh"):
        np.testing.assert_array_equal(loaded.state()[key],
                                      own.state()[key])
    codes = rules.THRESH_ENC[_seq(rng, 3 * 120, b"ACGTUN")].reshape(
        1, 3, 120).astype(np.int32)
    np.testing.assert_array_equal(loaded.colmax_batch(codes, "thresh"),
                                  own.colmax_batch(codes, "thresh"))
    with pytest.raises(ValueError, match="qprops_ssw"):
        loaded.load_state({"qprops_ssw": np.asarray(tpu.qprops_ssw)[:, :-1]})


def test_scan_codes_wrapper_rejects_other_devices():
    """The wrapper takes the plain version only for CPU tensors; any other
    device launches the kernel or raises — never falls back."""
    meta = torch.device("meta")
    codes = torch.zeros(2, 8, dtype=torch.uint8, device=meta)
    qprops = torch.zeros(4, 128, dtype=torch.int32, device=meta)
    tab = scan_codes.CodesTable(torch.zeros(192, dtype=torch.uint8,
                                            device=meta), "ssw")
    before = scan_codes.scan_codes_colmax.launches
    with pytest.raises(ValueError, match="unsupported device"):
        scan_codes.scan_codes_colmax(codes, qprops, tab, 16, "ssw")
    with pytest.raises(ValueError, match="unknown alphabet"):
        scan_codes.scan_codes_colmax(torch.zeros(2, 8, dtype=torch.uint8),
                                     torch.zeros(4, 128, dtype=torch.int32),
                                     tab, 16, "sw")
    assert scan_codes.scan_codes_colmax.launches == before
