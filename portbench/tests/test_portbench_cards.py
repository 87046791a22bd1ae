"""A cell on several cards: the program's round-robin over four engines
runs correct under the harness, and comes out not correct when the
fourth engine's batches hand back wrong triplexes (here on the port's
CPU engines, four of them); run.py keeps no more cards visible than the
cell asks for, decided before CUDA starts."""

import copy
import os
import subprocess
import sys

from portbench import harness, run

from .conftest import run_tiny


def test_a_tiny_four_engine_cell_is_correct(tiny_dp4_cell):
    result, lines = run_tiny(tiny_dp4_cell)
    assert result["correct"], lines
    assert result["failed"] == 0
    assert all(n["value"] == 0 for n in result["checks"].values())
    assert any(x.startswith("records checked against the reference: 8 ")
               for x in lines), lines


class _Altered:
    """A finalize task's future whose triplexes come back with their
    scores raised by one."""

    def __init__(self, fut):
        self.fut = fut

    def result(self, timeout=None):
        out = []
        for t in self.fut.result(timeout):
            t = copy.copy(t)
            t.score = t.score + 1
            out.append(t)
        return out


def test_the_fourth_engines_wrong_triplexes_are_not_correct(tiny_dp4_cell,
                                                            monkeypatch):
    from fasim_tpu_torch import cli
    from fasim_tpu_torch.scan import batched

    made: list = []
    make, process = cli.make_engine, batched._process_batch

    def make_engine(*args, **kwargs):
        engines = make(*args, **kwargs)
        made.append(engines)
        return engines

    def process_batch(*args, **kwargs):
        pairs = process(*args, **kwargs)
        eng = args[8]
        if eng is made[-1][3]:
            pairs = [(w, _Altered(fut)) for w, fut in pairs]
        return pairs

    monkeypatch.setattr(cli, "make_engine", make_engine)
    monkeypatch.setattr(batched, "_process_batch", process_batch)
    result, lines = run_tiny(tiny_dp4_cell)
    assert len(made[-1]) == 4
    assert result["correct"] is False, lines
    assert result["checks"]["record_rows_diff"]["value"] > 0, lines


def test_pin_cards_keeps_the_first_visible_cards():
    env = {"CUDA_VISIBLE_DEVICES": "3,1,0,2,5"}
    assert "5 visible, 4 kept" in run.pin_cards(4, env)
    assert env["CUDA_VISIBLE_DEVICES"] == "3,1,0,2"
    assert "4 visible, 1 kept" in run.pin_cards(1, env)
    assert env["CUDA_VISIBLE_DEVICES"] == "3"
    env = {"CUDA_VISIBLE_DEVICES": "GPU-a,GPU-b,,GPU-c"}
    assert "2 visible, 2 kept" in run.pin_cards(4, env)
    assert env["CUDA_VISIBLE_DEVICES"] == "GPU-a,GPU-b,,GPU-c"
    assert run.visible_cards({"CUDA_VISIBLE_DEVICES": ""}) == []


def test_run_py_pins_the_cards_before_cuda_starts():
    """With six cards named visible, a one-card cell keeps the first; the
    line comes before the look for a GPU, which fails here."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="4,5,0,1,2,3")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "neat1_peaks.peaks64", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=harness.ROOT, env=env,
                       capture_output=True, text=True)
    assert ("cards: 6 visible, 1 kept (CUDA_VISIBLE_DEVICES=4)"
            in r.stderr), r.stderr
    import torch

    if not torch.cuda.is_available():
        assert r.returncode != 0
        assert '"correct"' not in r.stdout
