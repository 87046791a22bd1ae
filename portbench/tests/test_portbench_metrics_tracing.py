"""The readers of the program's counters (scan_swept_per_needed,
window_roofline_pct) on synthetic records,
including a program that counts nothing, whose record must give None."""

import importlib

import pytest

from portbench import yardstick


def record(**stages):
    rec = {"window_s": 50.0, "bases": 2_000_000, "jobs": 13,
           "query_len": 22767, "transforms": 48, "segments": 832,
           "scanned": 2_000_000, "longest": 4894,
           "stages": {"output": 14.0, "device_wait": 1.8,
                      "host_candidate_wait": 24.0, "n_output": 13},
           "trace": {"busy_s": 5.5, "window_s": 50.0,
                     "kernels": {"void window_fwd_kernel<4, 32, 0>(...)":
                                 0.9,
                                 "void window_pairs_kernel<...>(...)": 0.3,
                                 "void scan_colmax_kernel<16>(...)": 4.0},
                     "gaps": []}}
    rec["stages"].update(stages)
    return rec


def read(name, rec):
    return importlib.import_module(f"portbench.metrics.{name}").read(rec)


NAMES = ["scan_swept_per_needed", "window_roofline_pct"]


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_the_counters_gives_nothing(name):
    assert read(name, record()) is None


def test_swept_over_needed_cells():
    need = 48 * 22767 * 2_000_000
    rec = record(n_scan_cells=2 * need, n_scan_cells_prewarm=need // 64)
    assert read("scan_swept_per_needed", rec) == pytest.approx(2 + 1 / 64)
    assert read("scan_swept_per_needed", record(
        n_scan_cells=need)) == pytest.approx(1.0)


def test_window_roofline_arithmetic():
    cells = 10 ** 12
    rec = record(n_window_cells=cells, n_window_cells_prewarm=10 ** 9)
    want = 100 * 5 * (cells + 10 ** 9) / yardstick.INT32_OPS / 1.2
    assert read("window_roofline_pct", rec) == pytest.approx(want)


def test_window_roofline_needs_the_trace_and_its_kernels():
    rec = record(n_window_cells=10 ** 12)
    assert read("window_roofline_pct", dict(rec, trace=None)) is None
    rec["trace"] = dict(rec["trace"], kernels={"copy": 1.0})
    assert read("window_roofline_pct", rec) is None


def test_the_frozen_window_op_count():
    from portbench.metrics import window_roofline_pct

    assert window_roofline_pct.WINDOW_OPS_PER_CELL == 5
