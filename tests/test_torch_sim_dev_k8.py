"""K8's schedule (fasim_tpu_torch/csrc/sim_forward.cu) on the CPU: a numpy
model of the kernel's strips, cell ring, drains and hand-offs, at edge
shapes, and the launch-shape helpers of fasim_tpu_torch/kernels/sim_dev.py
that size its launch.  The kernel's arithmetic is held against the JAX
package in tests/test_torch_sim_dev.py; the kernel itself runs on the card
(chip_smoke.py phase 3).

The model mirrors the kernel's index rules:

- a strip is 32 lanes x `rows` query rows; lane k runs column st - k + 1
  at step st, st = 0 .. N + 30;
- a warp's cell ring holds (row in band, column mod kCols), kCols = kDrain
  + 32; the warp drains chunk c (columns [c kDrain, (c + 1) kDrain),
  0-based) after step c kDrain + kDrain + 30, and the last, partial chunk
  after its last step; it stores only rows <= m;
- a block is one warp, one strip; lane 31 hands column j of its bottom
  row down at step j + 30; the strip below takes the row above BATCH_COLS
  columns at a time: at step st (st % BATCH_COLS == 0, st < N) it needs
  columns up to min(st + BATCH_COLS, N).

Each strip runs one step a tick when what it needs is there; the model
checks that every entry is written before it is read, that every cell (i
<= m, j <= N) is stored once and no phantom row at all, and that the chain
takes chain_steps.  test_python_copies_match_csrc holds the constants it
shares with the kernel against the kernel's source."""

import os
import re

import numpy as np
import pytest

from fasim_tpu_torch.kernels import sim_dev

BATCH = sim_dev.BATCH_COLS
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(sim_dev.__file__))), "csrc", "sim_forward.cu")


def _schedule(m: int, n: int, rows: int) -> np.ndarray:
    """Tick of every step of every strip of one pair, [strips, n + 31]."""
    shape = sim_dev.launch_shape(m, n, rows)
    S, steps = shape.strips, n + 31
    tick = np.full((S, steps), -1, np.int64)
    done = np.zeros(S, np.int64)  # steps each strip has run
    t = 0
    while (done < steps).any():
        st = done.copy()
        run = st < steps
        # the row above: columns up to min(st + BATCH, n) handed down
        need = np.minimum(st + BATCH, n)
        up_ok = np.ones(S, bool)
        up_ok[1:] = ((st[1:] >= n) | (st[1:] % BATCH != 0)
                     | (done[:-1] >= need[1:] + 31))
        go = run & up_ok
        assert go.any(), f"no strip can step at tick {t}: deadlock"
        tick[go, st[go]] = t
        done += go
        t += 1
    return tick


def _check_handoff(tick: np.ndarray, n: int) -> None:
    """Every column of a bottom row is written before the strip below reads
    it."""
    S = tick.shape[0]
    j = np.arange(1, n + 1)
    batch_start = (j - 1) // BATCH * BATCH
    for s in range(1, S):
        written = tick[s - 1, j + 30]
        taken = tick[s, batch_start]
        assert (written < taken).all(), (s, int(np.argmax(written >= taken)))


def _check_cells(m: int, n: int, rows: int, T: int) -> None:
    """The drains store every (p, i <= m, j <= n) once, no phantom row."""
    band = 32 * rows
    drain = sim_dev.drain_cols(rows)
    cols = drain + 32
    strips = sim_dev._strips(m, rows)
    stored = np.zeros((m, n), np.int64)
    # chunk c's drain step (in-loop), or n + 31 for the last partial one
    chunks = np.arange((n + drain - 1) // drain)
    at = chunks * drain + drain + 30
    at[at > n + 30] = n + 31
    assert (at[:-1] <= n + 30).all()
    # the ring slot of (lane, column jj): written at step jj + lane, drained
    # at its chunk's step, written again (column jj + cols) at jj + cols +
    # lane
    jj = np.arange(n)
    lane = np.arange(32)[:, None]
    written, drained = jj + lane, at[jj // drain]
    assert (written <= drained).all()
    again = jj + cols < n
    assert (drained[again] < (jj + cols + lane)[:, again]).all()
    for s in range(strips):
        first = s * band  # 0-based row
        last = min(first + band, m)
        for c in chunks:
            stored[first:last, c * drain:min(c * drain + drain, n)] += 1
    assert (stored == 1).all()
    assert strips * band >= m > (strips - 1) * band  # phantom rows: none
    # addresses (p m + i - 1) n + j - 1 of the T pairs: a bijection onto
    # [0, T m n)
    corner = ((T - 1) * m + m - 1) * n + n - 1
    assert corner == T * m * n - 1


EDGE_N = (1, 31, 32, 33, 63, 64, 65, 4366)


@pytest.mark.parametrize("rows", sim_dev.KERNEL_ROWS)
def test_schedule_edges(rows):
    """Every instantiation at its strip edges: m in {1, 31, 32 rows +- 1,
    2,812}, N at the column edges; T in {1, 2, 8} for the cell stores."""
    band = 32 * rows
    for m in sorted({1, 31, band - 1, band + 1, 2812}):
        for n in EDGE_N:
            if n == 4366 and m != 2812:
                continue
            for T in (1, 2, 8):
                _check_cells(m, n, rows, T)
            tick = _schedule(m, n, rows)
            _check_handoff(tick, n)
            assert tick.max() + 1 == sim_dev.chain_steps(m, n, rows), (m, n)


@pytest.mark.parametrize("m,n,t", [(2812, 4366, 2), (500, 1200, 8),
                                   (22767, 5000, 1), (1, 1, 1),
                                   (65536, 30000, 1)])
def test_kernel_rows_fits_shared_memory(m, n, t):
    """kernel_rows picks an instantiation whose block fits the 227 KB a
    block can use, and the launch helper takes it."""
    rows = sim_dev.kernel_rows(m, n, t)
    assert rows in sim_dev.KERNEL_ROWS
    shape = sim_dev.launch_shape(m, n, rows)
    assert shape.smem == sim_dev.smem_bytes(rows)
    assert shape.smem <= sim_dev.SMEM_LIMIT
    assert shape.strips * 32 * rows >= m > (shape.strips - 1) * 32 * rows


def test_every_instantiation_fits():
    """Every instantiation's block fits, 16 rows a lane included (a
    narrower ring: 16 columns a drain), and a block at 8 rows does not
    leave room for a second one."""
    for rows in sim_dev.KERNEL_ROWS:
        assert sim_dev.smem_bytes(rows) <= sim_dev.SMEM_LIMIT
        assert sim_dev.drain_cols(rows) == (16 if rows == 16 else 32)
    assert sim_dev.smem_bytes(16) == 512 * 48 * 8
    assert 2 * sim_dev.smem_bytes(8) > sim_dev.SMEM_LIMIT


def test_python_copies_match_csrc():
    """The constants sim_dev keeps of the kernel's layout (the batch of the
    row above, the 227 KB limit, the drain columns by rows a lane) are the
    kernel's own; chip_smoke.py phase 7 holds smem_bytes against the
    built library's fasim_sim_forward_smem."""
    src = open(CSRC).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kBatch") == sim_dev.BATCH_COLS
    assert const("kSmemLimit") == sim_dev.SMEM_LIMIT
    drain = re.search(r"kDrain = kRows >= (\d+) \? (\d+) : (\d+);", src)
    at, wide, narrow = map(int, drain.groups())
    for rows in sim_dev.KERNEL_ROWS:
        assert sim_dev.drain_cols(rows) == (wide if rows >= at else narrow)
    assert "Ring<kRows>::kBand * Ring<kRows>::kCols * 8" in src
    rows = sorted(int(r) for r in re.findall(r"sim_forward_kernel<(\d+)>",
                                             src))
    assert tuple(sorted(set(rows))) == sim_dev.KERNEL_ROWS


@pytest.mark.parametrize("args,match", [
    ((100, 100, 3), "rows 3 not in"),
    ((100, 100, 32), "rows 32 not in"),
    ((100, 100, 0), "rows 0 not in"),
    ((0, 100, 2), "no launch"),
    ((100, 0, 2), "no launch"),
    ((-5, 100, 1), "no launch"),
    ((2 ** 16, 2 ** 15, 2), "packed start"),
    ((2 ** 31, 1, 16), "packed start"),
])
def test_launch_shape_refuses(args, match):
    """The launch helper refuses what fasim_sim_forward refuses: rows not
    an instantiation, a packed start past the gate; and a shape with no
    cell (the entry launches nothing)."""
    with pytest.raises(ValueError, match=match):
        sim_dev.launch_shape(*args)


def test_launch_shape_at_the_gate():
    n = 5000
    m = (2 ** 31 - 1) // (n + 2) - 1  # the largest m inside the gate
    shape = sim_dev.launch_shape(m, n, 16)
    assert shape.strips == -(-m // 512)
    with pytest.raises(ValueError, match="packed start"):
        sim_dev.launch_shape(m + 1, n, 16)


def test_cells_times_its_pieces():
    """sim_forward_cells with a `times` dict gives the same cells as
    without, and one host time (no device time on the CPU) for each of
    CELLS_PIECES a call."""
    rng = np.random.default_rng(16)
    bases = np.frombuffer(b"ACGT", np.uint8)
    rna = bases[rng.integers(0, 4, 40)].copy()
    refs = [bases[rng.integers(0, 4, 60)].copy() for _ in range(2)]
    refs[1][10:40] = rna[:30]
    want = sim_dev.sim_forward_cells(rna, refs, [0, 200], "cpu")
    times = {}
    for k in (1, 2):
        got = sim_dev.sim_forward_cells(rna, refs, [0, 200], "cpu", times)
        assert len(got) == len(want)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert list(times) == list(sim_dev.CELLS_PIECES)
        for name in sim_dev.CELLS_PIECES:
            assert len(times[name]) == k
            assert all(d is None and h >= 0 for d, h in times[name])
    assert sum(len(w) for w in want) > 0
