"""The control (the reference in the program's place with identity and
stability in bfloat16) fails the check's comparison, here at a size the
CPU holds; portbench/control.py runs it at a cell's size on the card."""

from portbench import check, control


def test_the_bfloat16_control_is_not_correct(tiny_cell):
    _, spec = tiny_cell
    out = control.control_rows_diff(spec, seed=31, n_jobs=1, device="cpu")
    assert out["records"] == 2
    assert out["reference_rows"] > 0
    assert out["record_rows_diff"] > check.LIMITS["record_rows_diff"]
