"""Port's scan pass (K1 plain version, TorchScanEngine on the CPU) vs the
JAX reference engine `XlaScanEngine`, and the port's candidate packing vs
`pack_candidates_np`.

Every output is an integer array: the tolerance is 0 everywhere.  Inputs
come from numpy seeds and go through both packages.  The CUDA kernel of
K1 is held against the same plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from fasim_tpu import rules
from fasim_tpu.kernels.tpu import pack_candidates_np as jax_pack_np
from fasim_tpu.kernels.xla import XlaScanEngine
from fasim_tpu_torch.kernels import pack, scan
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


def _batch(segs, n):
    batch = np.zeros((len(segs), n), np.uint8)
    lengths = np.zeros(len(segs), np.int32)
    for i, s in enumerate(segs):
        batch[i, :len(s)] = s
        lengths[i] = len(s)
    return batch, lengths


def _engines(rna, scans):
    xla = XlaScanEngine(rna)
    xla.setup_scans(scans)
    port = TorchScanEngine(rna, device="cpu")
    port.setup_scans(scans)
    return xla, port


def _assert_same_scan(xla, port, batch, lengths):
    thresh_x, cm_x = xla.scan_segments(batch, lengths)
    thresh_p, cm_p = port.scan_segments(batch, lengths)
    np.testing.assert_array_equal(thresh_p.numpy(), thresh_x)
    np.testing.assert_array_equal(cm_p.numpy(), cm_x)
    return thresh_x, cm_x


@pytest.mark.parametrize("m,lens", [(130, (256, 200)), (97, (300,)),
                                    (40, (128, 17, 77))])
def test_scan_matches_xla_random(m, lens):
    rng = np.random.default_rng(7 + m)
    rna = _seq(rng, m)
    xla, port = _engines(rna, rules.scan_list(0, 0))
    batch, lengths = _batch([_seq(rng, n) for n in lens],
                            (max(lens) + 127) // 128 * 128)
    _assert_same_scan(xla, port, batch, lengths)


def test_scan_ragged_batch():
    """Right-padded shorter segments in one batch, reversed transforms
    included: pads must not perturb any value."""
    rng = np.random.default_rng(11)
    rna = _seq(rng, 64)
    xla, port = _engines(rna, rules.scan_list(0, 0))
    batch, lengths = _batch([_seq(rng, 200), _seq(rng, 140), _seq(rng, 3)],
                            256)
    _assert_same_scan(xla, port, batch, lengths)


def test_scan_byte_break_regime():
    """GA-rich query and segment drive scores past BYTE_SAT: thresholds
    stay exact and the uint8 clamp matches."""
    rng = np.random.default_rng(3)
    rna = np.frombuffer(b"GA" * 100, np.uint8).copy()
    seg = np.concatenate([_seq(rng, 50), np.frombuffer(b"GA" * 120, np.uint8),
                          _seq(rng, 60)])
    xla, port = _engines(rna, rules.scan_list(0, 0))
    batch, lengths = _batch([seg], 384)
    thresh, _ = _assert_same_scan(xla, port, batch, lengths)
    assert thresh.max() >= 251
    # the escalation rerun (full_prefix) returns the same thresholds
    thresh_full, _ = port.scan_segments(batch, lengths, full_prefix=True)
    np.testing.assert_array_equal(thresh_full.numpy(), thresh)


def test_fused_matches_two_pass():
    """Pure ACGT input: the fused single pass equals the real threshold
    alphabet pass of both packages."""
    rng = np.random.default_rng(5)
    rna = np.frombuffer(b"GA" * 80, np.uint8).copy()
    segs = [np.concatenate([_seq(rng, 100),
                            np.frombuffer(b"GA" * 90, np.uint8),
                            _seq(rng, 80)]),
            _seq(rng, 256)]
    xla, port = _engines(rna, rules.scan_list(0, 0))
    assert port.query_pure
    batch, lengths = _batch(segs, 384)
    fused = _assert_same_scan(xla, port, batch, lengths)
    xla.query_pure = port.query_pure = False  # force the two-pass path
    two = _assert_same_scan(xla, port, batch, lengths)
    np.testing.assert_array_equal(fused[0], two[0])
    np.testing.assert_array_equal(fused[1], two[1])


@pytest.mark.parametrize("impurity", ["N", "lowercase", "U-query"])
def test_impure_input_runs_threshold_alphabet(impurity):
    """N or lowercase segment bytes, or a U in the query, score
    differently in the two alphabets: the threshold pass must run."""
    rng = np.random.default_rng(9)
    rna = _seq(rng, 60)
    seg = _seq(rng, 200)
    if impurity == "N":
        seg[50:60] = ord("N")
    elif impurity == "lowercase":
        seg[50:60] = ord("a")
    else:
        rna[0] = ord("U")
    xla, port = _engines(rna, rules.scan_list(0, 0)[:12])
    assert port.query_pure == (impurity != "U-query")
    assert not (port.query_pure and scan.PURE_OR_PAD[seg].all())
    batch, lengths = _batch([seg], 256)
    _assert_same_scan(xla, port, batch, lengths)


def test_packed_matches_pack_candidates_np():
    """scan_segments_packed's (pos, val, cnt) == the JAX package's host
    mirror applied to the XLA engine's (thresh, cm)."""
    rng = np.random.default_rng(13)
    rna = _seq(rng, 48)
    xla, port = _engines(rna, rules.scan_list(0, 0))
    batch, lengths = _batch([_seq(rng, 400), _seq(rng, 260)], 512)
    thresh, cm = xla.scan_segments(batch, lengths)
    want = jax_pack_np(thresh, cm, lengths, port.PACK_K)
    out = port.scan_segments_packed(batch, lengths)
    assert len(out) == 6
    for got, ref in zip(out[2:5], want):
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k", [16, 384])
def test_pack_candidates_vs_jax_mirror(k):
    """Torch packing == the port's numpy mirror == fasim_tpu's mirror on a
    byte-saturated run and an overflow row (cnt > k)."""
    rng = np.random.default_rng(17)
    S, T, N = 3, 6, 512
    cm = rng.integers(0, 120, (S, T, N)).astype(np.uint8)
    cm[0, 0, 100:120] = 252
    cm[1, 2, :] = 90
    thresh = rng.integers(50, 140, (S, T)).astype(np.int32)
    lengths = np.array([512, 400, 333], np.int32)
    want = jax_pack_np(thresh, cm, lengths, k)
    mirror = pack.pack_candidates_np(thresh, cm, lengths, k)
    got = pack.pack_candidates(torch.from_numpy(thresh),
                               torch.from_numpy(cm),
                               torch.from_numpy(lengths), k)
    for a, b, c in zip(want, mirror, got):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c.numpy(), a)


def test_wide_segments_skip_packing():
    """Positions are int16: a batch wider than 32767 columns returns only
    (thresh, cm), like the JAX engine."""
    port = TorchScanEngine(np.frombuffer(b"ACGT", np.uint8).copy(),
                           device="cpu")
    port.setup_scans(rules.scan_list(0, 0)[:1])
    batch = np.zeros((1, 32768 + 128), np.uint8)
    batch[0, :4] = np.frombuffer(b"ACGT", np.uint8)
    out = port.scan_segments_packed(batch, np.array([4], np.int32))
    assert len(out) == 2


def test_kernel_wrappers_reject_other_devices():
    """A wrapper takes the plain version only for CPU tensors; any other
    device must launch the kernel or raise — never fall back.  K1's score
    table is a required argument."""
    meta = torch.device("meta")
    bases = torch.zeros(1, 8, dtype=torch.uint8, device=meta)
    lut6 = torch.zeros(1, 128, dtype=torch.int32, device=meta)
    qp = torch.zeros(5, 128, dtype=torch.int32, device=meta)
    tab = scan.ScanTable(torch.zeros(64 + 128, dtype=torch.uint8,
                                     device=meta), False)
    with pytest.raises(ValueError, match="unsupported device"):
        scan.scan_colmax(bases, bases, lut6, lut6, qp, tab, 16, False)
    with pytest.raises(TypeError):
        scan.scan_colmax(bases, bases, lut6, lut6, qp, 16, False)
    assert scan.scan_colmax.launches == 0
