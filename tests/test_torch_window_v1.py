"""K6 (FASIM_WIN_V1=1): the port's v1 window pass against the JAX
package's transposed Pallas window kernel.

`window_keys_ref` equals fasim_tpu.kernels.tpu._window_call in interpret
mode key for key (one and two windows per row, W 128 and 256); under the
switch the port's `window_pass` and `window_pass_specs` equal XlaScanEngine
and the v1 TpuScanEngine, forward and reverse; the engine routes every
window pass to K6 under FASIM_WIN_V1=1 and the uniform forward specs to K4
under FASIM_WIN_V3=0.  Every output is an integer array: tolerance 0.  The
CUDA kernel is held against the same plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_window import CHUNK, _long_rows

from fasim_tpu import rules
from fasim_tpu.kernels import tpu as ktpu
from fasim_tpu.kernels.xla import XlaScanEngine
from fasim_tpu_torch.kernels import engine as engine_mod
from fasim_tpu_torch.kernels import window_v1
from fasim_tpu_torch.kernels.engine import TorchScanEngine


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rna(rng, m):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m)].copy()


def _engines(rna, monkeypatch, scans=None, **env):
    """(XlaScanEngine, v1 TpuScanEngine in interpret mode, port engine on
    the CPU), the last two set up under `env` (default FASIM_WIN_V1=1)."""
    for key, val in (env or {"FASIM_WIN_V1": "1"}).items():
        monkeypatch.setenv(key, val)
    xla = XlaScanEngine(rna)
    tpu = ktpu.TpuScanEngine(rna, interpret=True)
    port = TorchScanEngine(rna, device="cpu")
    for eng in (xla, tpu, port):
        if scans is not None:
            eng.setup_scans(scans)
        eng.setup_windows(rna)
    return xla, tpu, port


def _segments(rng, lens, n):
    segs = np.zeros((len(lens), n), np.uint8)
    for i, ln in enumerate(lens):
        segs[i, :ln] = np.frombuffer(b"ACGTN", np.uint8)[
            rng.integers(0, 5, ln)]
    return segs, np.asarray(lens, np.int32)


@pytest.mark.parametrize("W,subw", [(128, 0), (256, 0), (128, 64)])
def test_window_keys_ref_matches_pallas(W, subw):
    """Raw keys, lane for lane, including lanes past every window's
    offset, phantom rows and the initial key of an mreal-0 window."""
    rng = np.random.default_rng(W + subw)
    m = 143
    rna = _rna(rng, m)
    nq = window_v1.query_rows(m)
    qc = np.full(nq, -1, np.int32)
    qc[:m] = rules.SSW_ENC[rna]
    R = 8
    nwin = W // (subw or W)
    codes = rng.integers(0, 5, (R, W)).astype(np.uint8)
    offs = rng.integers(0, m // 2, R * nwin).astype(np.int32)
    mreals = (m + rng.integers(0, 16, R * nwin)).astype(np.int32)
    offs[1], mreals[2] = 0, 0
    rmeta = np.zeros((R, 128), np.int32)
    for h in range(nwin):
        rmeta[:, 3 * h] = offs.reshape(R, nwin)[:, h]
        rmeta[:, 3 * h + 1] = mreals.reshape(R, nwin)[:, h]
    qrows = np.broadcast_to(qc.reshape(-1, 1, 128), (nq // 128, 8, 128))
    want = np.asarray(ktpu._window_call(
        jnp.asarray(codes.reshape(1, R, W)),
        jnp.asarray(rmeta.reshape(1, R, 128)), jnp.asarray(qrows), m=m,
        subw=subw, interpret=True)).reshape(R, W)
    got = window_v1.window_keys_ref(
        torch.from_numpy(codes), torch.from_numpy(qc),
        torch.from_numpy(offs), torch.from_numpy(mreals), m, subw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ends_from_stats_matches_jax():
    """The ends glue equals fasim_tpu's host mirror window_stats_to_ends,
    with terminate breaks, ties and best <= 0 rows."""
    rng = np.random.default_rng(2)
    R, W, m = 40, 64, 97
    mx = rng.integers(0, 30, (R, W)).astype(np.int32)
    mx[:3] = 0
    mrow = rng.integers(0, m, (R, W)).astype(np.int32)
    rlens = rng.integers(1, W + 1, R).astype(np.int32)
    terms = np.where(rng.random(R) < 0.5, -1,
                     rng.integers(5, 30, R)).astype(np.int32)
    want = ktpu.window_stats_to_ends(mx, mrow, terms, rlens, m)
    got = window_v1.ends_from_stats(*(torch.from_numpy(a) for a in (
        mx, mrow, terms, rlens)), m)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [143, CHUNK + 1, 68000])
@pytest.mark.parametrize("rev", [False, True])
def test_window_pass_v1_matches_xla_and_pallas(rev, m, monkeypatch):
    """Codes interface with random offs, terms, rlens and mreals; at a query
    just past 65,536 rows and at 68,000 too (K6's long form on the card),
    with offsets and mreals on both sides of 65,536, against XLA only (the
    Pallas interpreter is slow at that length)."""
    rng = np.random.default_rng(31 + rev + (m > 143) * m)
    rna = _rna(rng, m)
    xla, tpu, port = _engines(rna, monkeypatch)
    assert not tpu.win_v2 and port.win_v1
    tpu.win_rows = 8
    R, W = 13, 128
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
    c = port.window_pass(codes, offs, terms, rlens, mreals, rev=rev)
    if m <= CHUNK:
        b = tpu.window_pass(codes, offs, terms, rlens, mreals, rev=rev)
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(c, a)


@pytest.mark.parametrize("rev", [False, True])
def test_window_pass_specs_v1_matches_xla_and_pallas(rev, monkeypatch):
    """Specs interface: every width class, an odd count of <= 64 windows
    (paired two per kernel row, the last with a pad window), forward and
    reversed reads, offs, terms and mreals."""
    rng = np.random.default_rng(7 + rev)
    m = 70
    rna = _rna(rng, m)
    scans = rules.scan_list(0, 0)
    xla, tpu, port = _engines(rna, monkeypatch, scans)
    # the v1 kernel rows come in groups of 256 (512 windows <= 64 columns)
    tpu.WIN_BUCKETS = {w: (512,) for w in tpu.WIN_BUCKETS}
    segs, lens = _segments(rng, [640, 503, 640, 77], 640)
    rl = np.concatenate([rng.integers(4, 65, 9), rng.integers(65, 129, 4),
                         rng.integers(129, 257, 3)]).astype(np.int32)
    R = len(rl)
    spec = {
        "seg_idx": rng.integers(0, 4, R).astype(np.int32),
        "scan_idx": rng.integers(0, len(scans), R).astype(np.int32),
        "dirn": np.where(rng.random(R) < 0.5, 1, -1).astype(np.int32),
        "rlens": rl,
        "offs": rng.integers(0, m // 2, R).astype(np.int32),
        "terms": np.where(rng.random(R) < 0.5, -1,
                          rng.integers(5, 40, R)).astype(np.int32),
        "mreals": (m + rng.integers(0, 16, R)).astype(np.int32),
    }
    base = np.empty(R, np.int32)
    for r in range(R):
        n = lens[spec["seg_idx"][r]]
        w = min(int(rl[r]), int(n))
        spec["rlens"][r] = w
        base[r] = (rng.integers(0, n - w + 1) if spec["dirn"][r] == 1
                   else rng.integers(w - 1, n))
    spec["base"] = base
    perm = rng.permutation(R)  # mix the classes in spec order
    spec = {k: v[perm] for k, v in spec.items()}
    assert (spec["rlens"] <= 64).sum() % 2 == 1
    a = np.asarray(xla.window_pass_specs(segs, lens, spec, rev=rev))
    b = tpu.window_pass_specs(segs, lens, spec, rev=rev)
    c = port.window_pass_specs(segs, lens, spec, rev=rev)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(c, a)


def _spy(monkeypatch):
    """Record the window wrappers the engine reaches."""
    calls = []
    for name in ("window_fwd", "window_general", "window_v1"):
        real = getattr(engine_mod, name)

        def spy(*args, _name=name, _real=real):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(engine_mod, name, spy)
    return calls


def _fwd_spec(rng, lens, n_scans, m16):
    rows = 7
    spec = {"seg_idx": rng.integers(0, len(lens), rows).astype(np.int32),
            "scan_idx": rng.integers(0, n_scans, rows).astype(np.int32),
            "dirn": np.ones(rows, np.int32),
            "rlens": rng.integers(10, 200, rows).astype(np.int32),
            "offs": np.zeros(rows, np.int32),
            "terms": np.full(rows, -1, np.int32),
            "mreals": np.full(rows, m16, np.int32)}
    spec["base"] = np.array([rng.integers(0, lens[s] - r + 1) for s, r in
                             zip(spec["seg_idx"], spec["rlens"])], np.int32)
    return spec


@pytest.mark.parametrize("env,want_fwd,want_rev", [
    ({}, {"window_fwd"}, {"window_general"}),
    ({"FASIM_WIN_V3": "0"}, {"window_general"}, {"window_general"}),
    ({"FASIM_WIN_V1": "1"}, {"window_v1"}, {"window_v1"}),
])
def test_window_switch_routing(env, want_fwd, want_rev, monkeypatch):
    """FASIM_WIN_V1=1 sends every window pass to K6, FASIM_WIN_V3=0 the
    uniform forward specs to K4 (tpu.py:470, 510, 644-649), and the
    results stay those of the default routing."""
    for key in ("FASIM_WIN_V1", "FASIM_WIN_V3"):
        monkeypatch.delenv(key, raising=False)
    rng = np.random.default_rng(5)
    m = 60
    rna = _rna(rng, m)
    scans = rules.scan_list(0, 0)
    segs, lens = _segments(rng, [300, 250], 320)
    spec = _fwd_spec(rng, lens, len(scans), (m + 15) // 16 * 16)
    default = TorchScanEngine(rna, device="cpu")
    default.setup_scans(scans)
    default.setup_windows(rna)
    want = [default.window_pass_specs(segs, lens, spec, rev=r)
            for r in (False, True)]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    port = TorchScanEngine(rna, device="cpu")
    port.setup_scans(scans)
    port.setup_windows(rna)
    calls = _spy(monkeypatch)
    for rev, names in ((False, want_fwd), (True, want_rev)):
        calls.clear()
        got = port.window_pass_specs(segs, lens, spec, rev=rev)
        assert set(calls) == names, rev
        np.testing.assert_array_equal(got, want[rev])
    calls.clear()
    codes = np.zeros((2, 64), np.uint8)
    port.window_pass(codes, np.zeros(2, np.int32), np.full(2, -1, np.int32),
                     np.full(2, 40, np.int32), np.full(2, m, np.int32),
                     rev=False)
    assert set(calls) == ({"window_v1"} if env.get("FASIM_WIN_V1")
                          else {"window_general"})


def test_window_keys_rejects_other_devices():
    """K6's long form (window_v1_long, which took over from the int32 keys
    kernel) refuses devices other than cpu and cuda before any launch."""
    meta = torch.device("meta")
    codes = torch.zeros(2, 128, dtype=torch.uint8, device=meta)
    rows = torch.zeros(2, dtype=torch.int32, device=meta)
    tab = torch.zeros(128, 8, dtype=torch.int8, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        window_v1.window_v1_long(codes, rows, rows, rows, rows, rows, 10, tab)
    assert window_v1.window_v1_long.launches == 0
