"""K8, the device SIM forward scan of `-F` (fasim_tpu_torch/kernels/
sim_dev.py), on the CPU against the JAX package's fasim_tpu/kernels/
sim_dev.py: the plain version and a numpy model of the kernel's
recurrence equal to JAX's `_sim_forward` exactly, the qualifying-cell
streams equal, and the port's host replay equal to its own `sim_scan` and
to the JAX package's replay.  The kernel itself runs on the card
(chip_smoke.py phase 3)."""

import numpy as np
import pytest
import torch

from fasim_tpu import native as jax_native
from fasim_tpu.kernels import sim_dev as jax_sim_dev
from fasim_tpu_torch import native
from fasim_tpu_torch.kernels import sim_dev

BASES = np.frombuffer(b"ACGT", np.uint8)
_Q, _R = 120, 40
_ONE = 1 << 32
_NEG = -(1 << 62)


def _pair(rng, m: int, n: int, t: int, kind: str):
    """A query of m bases and t references of n, made with rng; `kind`
    plants homology (10% mutated), a run of N, or a non-ACGT query byte."""
    rna = BASES[rng.integers(0, 4, m)].copy()
    refs = [BASES[rng.integers(0, 4, n)].copy() for _ in range(t)]
    if kind in ("planted", "nrun") and m >= 4 and n >= 4:
        for ref in refs:
            ql = int(rng.integers(min(m, n) // 2, min(m, n) + 1))
            lo = int(rng.integers(0, n - ql + 1))
            piece = rna[:ql].copy()
            muts = rng.random(ql) < 0.1
            piece[muts] = BASES[rng.integers(0, 4, int(muts.sum()))]
            ref[lo:lo + ql] = piece
    if kind == "nrun":
        for ref in refs:
            a = int(rng.integers(0, n))
            ref[a:a + max(1, n // 6)] = ord("N")
    if kind == "query_n":
        rna[int(rng.integers(0, m))] = ord("N")
        rna[int(rng.integers(0, m))] = ord("u")
    return rna, refs


def _jax_forward(rna, refs):
    """JAX's (cs, ct) as [T, m, N] (transposed, pad rows dropped)."""
    m = len(rna)
    q, r = sim_dev.encode(rna, refs)
    cs, ct = jax_sim_dev._sim_forward(q, r, mp=len(q))
    return (np.asarray(cs).transpose(0, 2, 1)[:, :m],
            np.asarray(ct).transpose(0, 2, 1)[:, :m])


def _kernel_model(rna, refs):
    """numpy model of csrc/sim_forward.cu's recurrence: one int64 key
    (score << 32) | t a cell, row-sequential D with its short step
    D(i+1) = max(D(i) - R, pre - (Q + R)), swept over anti-diagonals (the
    kernel's wavefront).  Returns (cs, ct) int32[T, m, N]."""
    q, r = sim_dev.encode(rna, refs)
    m, (T, N) = len(rna), r.shape
    W = N + 2
    q = q[:m].astype(np.int64)
    r = r.astype(np.int64)
    C = np.zeros((T, m + 1, N + 1), np.int64)
    F = np.zeros((T, m + 1, N + 1), np.int64)
    Dn = np.full((T, m + 1, N + 1), _NEG, np.int64)  # D of the row below
    C[:, 0, :] = np.arange(N + 1)                     # row 0: (0, j)
    rows = np.arange(m + 1, dtype=np.int64)
    C[:, :, 0] = rows * W                             # column 0: (0, i W)
    F[:, :, 0] = -_Q * _ONE + rows * W
    for dsum in range(2, m + N + 1):
        i = np.arange(max(1, dsum - N), min(m, dsum - 1) + 1)
        j = dsum - i
        qc, rc = q[i - 1][None, :], r[:, j - 1]
        s = np.where((qc | rc) < 4, np.where(qc == rc, 50, -40), 0)
        fv = np.maximum(F[:, i, j - 1] - _R * _ONE,
                        C[:, i, j - 1] - (_Q + _R) * _ONE)
        pre = C[:, i - 1, j - 1] + s * _ONE
        pre = np.where(pre < _ONE, i * W + j, pre)
        pre = np.maximum(pre, fv)
        d = Dn[:, i - 1, j]
        C[:, i, j] = np.maximum(pre, d)
        Dn[:, i, j] = np.maximum(d - _R * _ONE, pre - (_Q + _R) * _ONE)
        F[:, i, j] = fv
    key = C[:, 1:, 1:]
    return ((key >> 32).astype(np.int32),
            (key & 0xFFFFFFFF).astype(np.int32))


# (m, n, T, kind): m from 1 to 160 (not all multiples of 8), n from 1 to
# 400, T from 1 to 3
CASES = [
    (1, 1, 1, "random"),
    (1, 57, 2, "random"),
    (7, 33, 3, "random"),
    (8, 400, 1, "planted"),
    (33, 1, 2, "random"),
    (45, 120, 3, "planted"),
    (64, 97, 2, "nrun"),
    (100, 250, 1, "query_n"),
    (131, 64, 2, "planted"),
    (160, 300, 1, "nrun"),
]


@pytest.mark.parametrize("m,n,t,kind", CASES)
def test_sim_forward_ref_matches_jax(m, n, t, kind):
    rng = np.random.default_rng(1000 + m * 7 + n)
    rna, refs = _pair(rng, m, n, t, kind)
    want_s, want_t = _jax_forward(rna, refs)
    q, r = sim_dev.encode(rna, refs)
    cs, ct = sim_dev.sim_forward(torch.from_numpy(q), torch.from_numpy(r), m)
    assert cs.shape == (t, m, n) and cs.dtype == torch.int32
    np.testing.assert_array_equal(cs.numpy(), want_s)
    np.testing.assert_array_equal(ct.numpy(), want_t)


@pytest.mark.parametrize("m,n,t,kind", CASES)
def test_kernel_recurrence_matches_jax(m, n, t, kind):
    """The kernel's int64-key recurrence with the sequential D (not JAX's
    prefix) gives JAX's cells exactly."""
    rng = np.random.default_rng(2000 + m * 7 + n)
    rna, refs = _pair(rng, m, n, t, kind)
    want_s, want_t = _jax_forward(rna, refs)
    got_s, got_t = _kernel_model(rna, refs)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_t, want_t)


def test_kernel_model_ties():
    """Repeats and N runs make exact score ties that only t decides."""
    rna = np.frombuffer(b"ACACACACACACGTGT" * 3, np.uint8).copy()
    ref = np.frombuffer(b"ACACAC" * 20 + b"N" * 12 + b"ACAC" * 10,
                        np.uint8).copy()
    want = _jax_forward(rna, [ref, ref[::-1].copy()])
    got = _kernel_model(rna, [ref, ref[::-1].copy()])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_forward_cells_match_jax(seed):
    rng = np.random.default_rng(300 + seed)
    m, n = int(rng.integers(40, 160)), int(rng.integers(80, 400))
    rna, refs = _pair(rng, m, n, 3, "planted" if seed != 2 else "nrun")
    mins = [int(x) for x in rng.integers(20, 200, 3)]
    got = sim_dev.sim_forward_cells(rna, refs, mins, device="cpu")
    want = jax_sim_dev.sim_forward_cells(rna, refs, mins)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape[1] == 5
        np.testing.assert_array_equal(g, w)
    assert sum(len(g) for g in got) > 0


@pytest.mark.parametrize("case", range(6))
def test_sim_device_forward_replay(case):
    """Forward scan on the device path (the plain version here) + the
    port's host replay == the port's host sim_scan and the JAX package's
    replay, row for row (tests/test_sim.py::
    test_sim_device_forward_replay)."""
    rng = np.random.default_rng(11 + case)
    m = int(rng.integers(40, 160))
    n = int(rng.integers(80, 400))
    rna = BASES[rng.integers(0, 4, m)].copy()
    seq = BASES[rng.integers(0, 4, n)].copy()
    if case % 2 == 0:  # plant homology so extraction does real work
        ql = min(m, int(rng.integers(20, 60)))
        lo = int(rng.integers(0, n - ql))
        piece = rna[:ql].copy()
        muts = rng.random(ql) < 0.1
        piece[muts] = BASES[rng.integers(0, 4, int(muts.sum()))]
        seq[lo:lo + ql] = piece
    if case == 5:
        seq[10:20] = ord("N")
    src = seq.copy()
    min_score = int(rng.integers(20, 80))
    args = (rna.tobytes(), seq.tobytes(), src.tobytes(), 0, min_score, 0,
            1, 10, 100000, 1, 0)
    host = native.sim_scan(*args)
    cells = sim_dev.sim_forward_cells(rna, [seq], [min_score], "cpu")[0]
    dev = native.sim_scan_replay(*args, cells)
    assert dev == host, (case, m, n, min_score)
    assert dev == jax_native.sim_scan_replay(*args, cells)


def test_sim_device_ok_gate():
    """(m + 1)(N + 2) < 2^31 on both sides of the edge."""
    n = 5000
    m = (2 ** 31 - 1) // (n + 2) - 1  # largest m inside
    assert sim_dev.sim_device_ok(m, n)
    assert not sim_dev.sim_device_ok(m + 1, n)
    assert sim_dev.sim_device_ok(1, 1)
    assert not sim_dev.sim_device_ok(2 ** 16, 2 ** 15)
    q = torch.zeros(m + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="packed start"):
        sim_dev.sim_forward(q, torch.zeros((1, n), dtype=torch.int32), m + 1)


def test_sim_forward_rejects_other_devices():
    q = torch.zeros(8, dtype=torch.int32, device="meta")
    refs = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sim_dev.sim_forward(q, refs, 8)


@pytest.mark.parametrize("m,n", [(1, 1), (2812, 4366), (22767, 5000),
                                 (500, 1200)])
def test_kernel_rows_is_an_instantiation(m, n):
    assert sim_dev.kernel_rows(m, n) in sim_dev.KERNEL_ROWS


@pytest.mark.parametrize("m,n,tg", [(500, 1200, 8), (2812, 4366, 2),
                                    (22767, 5000, 1)])
def test_device_sim_groups_and_order(monkeypatch, m, n, tg):
    """scan/batched.py's device stage: groups of tg transforms (the ~256 MB
    rule of fasim_tpu/scan/batched.py), every pair replayed once, the
    hits in scan order however the replays finish, with the host queue
    drained on the way (one core: at most 2 * tg pairs wait)."""
    import random
    import time

    from fasim_tpu_torch.scan import batched

    rna = np.zeros(m, np.uint8)
    pairs = [(np.zeros(n, np.uint8), None) for _ in range(48)]
    groups = []

    def cells(rna_, refs, mins, device):
        groups.append((len(refs), list(mins), device))
        return [np.full((1, 5), k, np.int32) for k in mins]

    def one(k, c):
        time.sleep(random.random() * 0.002)
        assert int(c[0, 0]) == k
        return [k]

    monkeypatch.setattr(batched, "sim_forward_cells", cells)
    monkeypatch.setattr(batched.os, "cpu_count", lambda: 1)
    got = batched._device_sim(rna, pairs, list(range(48)), "cpu", one)
    assert got == list(range(48))
    assert [g[0] for g in groups] == [tg] * (48 // tg)
    assert [k for g in groups for k in g[1]] == list(range(48))
    assert {g[2] for g in groups} == {"cpu"}
