"""K7 (FASIM_SCAN16=1): the port's 16-bit scan pass against the JAX
package's int16 Pallas path.

`scan_colmax16_ref` (torch.int16 arithmetic) through TorchScanEngine on the
CPU equals TpuScanEngine(interpret=True) under the same switch — the int16
branch of _kernel2_call in interpret mode, as tests/test_scan16.py runs it
— and XlaScanEngine, at the pad boundaries m in {61, 64, 190}, fused and
unfused.  The engine takes K7 exactly where fasim_tpu's gate and per-pass
rule put the int16 path.  Every output is an integer array: tolerance 0.
The CUDA kernel is held against the same plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from fasim_tpu import rules
from fasim_tpu.kernels.tpu import TpuScanEngine
from fasim_tpu.kernels.xla import XlaScanEngine
from fasim_tpu_torch.kernels import engine as engine_mod
from fasim_tpu_torch.kernels import scan
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


def _port(rna, scans, monkeypatch, scan16=True, **kw):
    monkeypatch.setenv("FASIM_SCAN16", "1" if scan16 else "0")
    port = TorchScanEngine(rna, device="cpu", **kw)
    port.setup_scans(scans)
    return port


def _spy(monkeypatch, names=("scan_colmax", "scan_colmax16")):
    """Record which wrapper the engine calls, per call, in order."""
    calls = []
    for name in names:
        real = getattr(engine_mod, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(engine_mod, name, spy)
    return calls


@pytest.mark.parametrize("m", [61, 64, 190])
@pytest.mark.parametrize("impure", [False, True])
def test_engine_scan16_matches_pallas_int16_and_xla(m, impure, monkeypatch):
    """Fused (pure ACGT) and unfused (n bytes: the threshold alphabet runs
    too) batches; the port runs K7's plain version for every pass."""
    rng = np.random.default_rng(m + 1000 * impure)
    rna = _seq(rng, m)
    scans = rules.scan_list(0, 0)
    segs = [_seq(rng, 200) for _ in range(2)]
    if impure:
        segs[1][40:50] = ord("n")
    batch, lengths = _batch(segs, 256)
    monkeypatch.setenv("FASIM_SCAN16", "1")
    tpu = TpuScanEngine(rna, interpret=True)
    tpu.setup_scans(scans)
    assert tpu.scan16
    xla = XlaScanEngine(rna)
    xla.setup_scans(scans)
    port = _port(rna, scans, monkeypatch)
    calls = _spy(monkeypatch)
    g_t, c_t = (np.asarray(a) for a in tpu.scan_segments(batch, lengths))
    g_x, c_x = (np.asarray(a) for a in xla.scan_segments(batch, lengths))
    g_p, c_p = (a.numpy() for a in port.scan_segments(batch, lengths))
    assert calls == ["scan_colmax16"] * (2 if impure else 1)
    for want in ((g_t, c_t), (g_x, c_x)):
        np.testing.assert_array_equal(g_p, want[0])
        np.testing.assert_array_equal(c_p, want[1])


@pytest.mark.parametrize("m,n,alphabet", [
    (130, 256, b"ACGT"),       # one strip
    (600, 128, b"ACGTNacgt"),  # two strips, threshold alphabet bytes
    (200, 384, b"GA"),         # GA repeats: scores past 251
])
def test_scan16_ref_equals_int32_ref(m, n, alphabet):
    """The int16 plain version equals K1's int32 plain version on both
    alphabets, including scores past 251 and queries over 512 rows."""
    rng = np.random.default_rng(m)
    if alphabet == b"GA":
        rna = np.frombuffer(b"GA" * (m // 2), np.uint8).copy()
        segs = [np.frombuffer(b"GA" * (n // 2), np.uint8).copy(),
                _seq(rng, n // 2)]
    else:
        rna = _seq(rng, m, b"ACGTU")
        segs = [_seq(rng, n, alphabet), _seq(rng, n // 2, alphabet)]
    port = TorchScanEngine(rna, device="cpu")
    port.setup_scans(rules.scan_list(0, 0))
    batch, lengths = _batch(segs, n)
    bases, bases_rev = scan.decode_bases(torch.from_numpy(batch),
                                         torch.from_numpy(lengths))
    d = port._dev
    for alpha, thresh in (("ssw", False), ("thresh", True)):
        args = (bases, bases_rev, d[f"lut6_{alpha[0]}"], d["istr"],
                d[f"qp2_{alpha}"], port.m16, thresh)
        cm16, gm16 = scan.scan_colmax16_ref(*args)
        cm32, gm32 = scan.scan_colmax_ref(*args)
        assert torch.equal(cm16, cm32) and torch.equal(gm16, gm32), alpha
    if alphabet == b"GA":
        assert int(gm16.max()) >= 251


def test_scan16_refuses_outside_gate():
    """An odd transform count or 5 * min(m16, N) > 30000 is refused by the
    wrapper and the plain version alike."""
    rng = np.random.default_rng(4)
    port = TorchScanEngine(_seq(rng, 40), device="cpu")
    port.setup_scans(rules.scan_list(0, 0)[:3])
    batch, lengths = _batch([_seq(rng, 100)], 128)
    bases, bases_rev = scan.decode_bases(torch.from_numpy(batch),
                                         torch.from_numpy(lengths))
    d = port._dev
    odd = (bases, bases_rev, d["lut6_s"], d["istr"], d["qp2_ssw"])
    # the wrapper takes K7's table, the plain version does not
    fns = ((scan.scan_colmax16, (d["stab16_ssw"],)),
           (scan.scan_colmax16_ref, ()))
    for fn, tab in fns:
        with pytest.raises(ValueError, match="int16 gate"):
            fn(*odd, *tab, port.m16, False)
    assert scan.in_gate16(2, 6000, 6016) and not scan.in_gate16(2, 6016,
                                                                6016)
    wide = torch.zeros(1, 6016, dtype=torch.uint8)
    for fn, tab in fns:
        with pytest.raises(ValueError, match="int16 gate"):
            fn(wide, wide, d["lut6_s"][:2], d["istr"][:2], d["qp2_ssw"],
               *tab, 6016, False)


@pytest.mark.parametrize("scan16,n_scans,m,n,impure,full_prefix,want", [
    # switch off: K1 for every pass
    (False, 48, 40, 128, True, False, ["scan_colmax"] * 2),
    # inside the gate: K7, fused (one pass) and unfused (two)
    (True, 48, 40, 128, False, False, ["scan_colmax16"]),
    (True, 48, 40, 128, True, False, ["scan_colmax16"] * 2),
    # the escalation rerun: fused -> K1; unfused -> ssw K7, threshold K1
    (True, 48, 40, 128, False, True, ["scan_colmax"]),
    (True, 48, 40, 128, True, True, ["scan_colmax16", "scan_colmax"]),
    # odd transform count, and 5 * min(m16, N) > 30000: K1
    (True, 47, 40, 128, True, False, ["scan_colmax"] * 2),
    (True, 2, 6010, 6016, True, False, ["scan_colmax"] * 2),
])
def test_engine_routes_scan16(scan16, n_scans, m, n, impure, full_prefix,
                              want, monkeypatch):
    """The gate of tpu.py:371-372 and the per-pass rule of tpu.py:1113-1125,
    read from the wrappers the engine calls (stubs: nothing is computed)."""
    rng = np.random.default_rng(n_scans + m)
    rna = _seq(rng, m)
    port = _port(rna, rules.scan_list(0, 0)[:n_scans], monkeypatch, scan16)
    calls = []

    def stub(name):
        def run(bases, bases_rev, lut6, *args, want_cm=True, **kw):
            calls.append(name)
            S, N = bases.shape
            T = lut6.shape[0]
            return (torch.zeros(S, T, N, dtype=torch.uint8) if want_cm
                    else None), torch.zeros(S, T, dtype=torch.int32)
        return run

    for name in ("scan_colmax", "scan_colmax16"):
        monkeypatch.setattr(engine_mod, name, stub(name))
    seg = _seq(rng, n)
    if impure:
        seg[5] = ord("N")
    batch, lengths = _batch([seg], n)
    port.scan_segments(batch, lengths, full_prefix=full_prefix)
    assert calls == want


def test_scan16_ignored_by_v1_engine(monkeypatch):
    """use_v2=False runs K5 whatever FASIM_SCAN16 says, as fasim_tpu's
    _device_scan has no 16-bit variant; so does the per-segment call."""
    rng = np.random.default_rng(6)
    rna = _seq(rng, 50)
    scans = rules.scan_list(0, 0)
    batch, lengths = _batch([_seq(rng, 120)], 128)
    want = _port(rna, scans, monkeypatch, False).scan_segments(batch,
                                                               lengths)
    port = _port(rna, scans, monkeypatch, True, use_v2=False)
    calls = _spy(monkeypatch)
    got = port.scan_segments(batch, lengths)
    seq2 = [rules.make_scan_strings(batch[0, :120], s)[0] for s in scans]
    port(rna, seq2)
    assert calls == []
    for a, b in zip(got, want):
        assert torch.equal(a, b)
