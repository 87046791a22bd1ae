"""The plain reference against the program on the CPU: the port's CPU
engine (--tpu-engine torch) through cli.main on a tiny job, every
triplex and every output file; libstdc++'s sort emulation against the
port's native sort; the bfloat16 control's rounding."""

import random

import numpy as np
import pytest

from portbench import check
from portbench.reference import fastsim, stdsort

from .conftest import run_tiny


def test_a_tiny_cell_is_correct_and_checks_every_record(tiny_cell):
    result, lines = run_tiny(tiny_cell)
    assert result["correct"], lines
    assert result["failed"] == 0
    assert result["checks"]["record_rows_diff"]["value"] == 0
    assert any("records checked against the reference: " in x
               for x in lines)
    assert list(result)[-1] == "checks"


def _port_sort():
    from fasim_tpu_torch import native

    return native


@pytest.mark.parametrize("seed", range(6))
def test_sort_by_class_matches_libstdcxx(seed):
    native = _port_sort()
    rng = random.Random(seed)
    n = rng.choice([5, 17, 40, 300, 2000])
    motif = [rng.randrange(0, rng.choice([2, 5, 30])) for _ in range(n)]
    want = list(native.sort_by_motif(np.array(motif, np.int32)))
    v = [(m, k) for k, m in enumerate(motif)]
    stdsort.sort(v, lambda a, b: a[0] < b[0])
    assert [k for _, k in v] == want


@pytest.mark.parametrize("seed", range(6))
def test_dedup_chain_matches_libstdcxx(seed):
    native = _port_sort()
    rng = random.Random(100 + seed)
    n = rng.choice([3, 16, 17, 60, 400])
    rows = []
    for _ in range(n):
        a = rng.randrange(1, 60)
        b = rng.randrange(1, 60)
        rows.append(fastsim.Hit(a, a + rng.randrange(0, 30), b,
                                b + rng.randrange(0, 30), 0, 1, 1, 20,
                                float(rng.randrange(40, 60)), 0.0, 0.0,
                                "", ""))
    want = list(native.fastsim_dedup(
        np.array([h.stari for h in rows], np.int32),
        np.array([h.endi for h in rows], np.int32),
        np.array([h.starj for h in rows], np.int32),
        np.array([h.endj for h in rows], np.int32),
        np.array([h.score for h in rows], np.float32)))
    got = fastsim.dedup(rows)
    ids = {id(h): k for k, h in enumerate(rows)}
    assert [ids[id(h)] for h in got] == want


def test_bfloat16_rounds_to_nearest_even():
    assert fastsim.bfloat16(1.0) == 1.0
    assert fastsim.bfloat16(60.0) == 60.0
    assert fastsim.bfloat16(3.7) == np.float32(3.703125)
    assert fastsim.bfloat16(1 + 2**-8) == 1.0  # a tie goes to even


def test_rows_diff_counts_extra_missing_and_order():
    a = fastsim.Hit(1, 2, 3, 4, 0, 1, 1, 50, 9.0, 1.0, 1.0, "A", "T")
    b = fastsim.Hit(5, 6, 7, 8, 0, 1, 1, 50, 9.0, 1.0, 1.0, "A", "T")
    assert check.rows_diff([a, b], [a, b]) == 0
    assert check.rows_diff([b, a], [a, b]) == 1
    assert check.rows_diff([a], [a, b]) == 1
    assert check.rows_diff([a, a], [b]) == 3
