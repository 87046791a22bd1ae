"""The port's per-segment path (`fasim_tpu_torch.scan.pipeline`) and `-F`
(exact SIM) on the CPU: output files byte-identical to the committed
goldens, and the port's `long_target` equal, field by field, to the JAX
package's.

Engines: a CPU `TorchScanEngine` (K5's and the window kernels' plain
versions) and the port's NumPy golden `numpy_engine`; the JAX side runs
its own `numpy_engine`.  The CUDA path of the same code is run on the card
by chip_smoke.py (meg3_sub16, h19F_trunc)."""

import dataclasses
import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ORACLE
from fasim_tpu.scan import pipeline as jax_pipeline
from fasim_tpu_torch.config import Params
from fasim_tpu_torch.io import fasta
from fasim_tpu_torch.kernels.batch_np import numpy_engine
from fasim_tpu_torch.kernels.engine import TorchScanEngine
from fasim_tpu_torch.post.output import print_result
from fasim_tpu_torch.scan import pipeline

GOLDEN = os.path.join(ORACLE, "golden")
REPO = os.path.dirname(ORACLE)

# (golden case, DNA, RNA, Params fields); h19F_trunc is `-F -lg 40`
CASES = {
    "meg3_sub3": ("meg3sub3.fa", "MEG3.fa", {}),
    "h19_lg40": ("testDNA.fa", "H19.fa", {"c_length": 40}),
    "h19F_trunc": ("testDNAt.fa", "H19t.fa",
                   {"c_length": 40, "do_fast_sim": False}),
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # six xdist workers share the box
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params(tmp_path, case) -> Params:
    f1, f2, fields = CASES[case]
    for f in (f1, f2):
        shutil.copy(os.path.join(ORACLE, f), tmp_path)
    (tmp_path / "out").mkdir()
    # relative paths: the output file names embed the DNA path as given
    # (main:123); the caller runs in tmp_path
    return Params(file1path=f1, file2path=f2, outpath="out/", **fields)


def _assert_golden_files(tmp_path, case):
    golden_dir = os.path.join(GOLDEN, case)
    expected = sorted(f for f in os.listdir(golden_dir)
                      if not f.startswith("stdout"))
    assert sorted(os.listdir(tmp_path / "out")) == expected
    for name in expected:
        assert filecmp.cmp(tmp_path / "out" / name,
                           os.path.join(golden_dir, name),
                           shallow=False), f"{case}/{name} differs"


def _run_per_segment(p: Params, engine):
    records, lnc_name, _, tlist = pipeline.scan_file(p, engine=engine)
    first = records[0]
    print_result(p, first.species, lnc_name, tlist, first.chro_tag,
                 len(first.seq), first.start_genome)


@pytest.mark.parametrize("case,engine", [
    ("meg3_sub3", "torch"),
    ("h19_lg40", "torch"),
    ("h19F_trunc", "torch"),
    ("h19F_trunc", "numpy"),
])
def test_per_segment_byte_identical(tmp_path, monkeypatch, case, engine):
    monkeypatch.chdir(tmp_path)
    p = _params(tmp_path, case)
    if engine == "numpy":
        eng = numpy_engine
    else:
        _, rna = fasta.read_rna(p.file2path)
        eng = TorchScanEngine(rna, device="cpu")
    _run_per_segment(p, eng)
    _assert_golden_files(tmp_path, case)


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_minus_F_cli_byte_identical(tmp_path, engine):
    """-F through the port's CLI (batched driver with the CPU engine, or
    the per-segment NumPy path): files and stdout except `Running time
    is` equal to the h19F_trunc golden."""
    f1, f2, _ = CASES["h19F_trunc"]
    for f in (f1, f2):
        shutil.copy(os.path.join(ORACLE, f), tmp_path)
    (tmp_path / "out").mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "fasim_tpu_torch.cli", "-f1", f1, "-f2", f2,
         "-O", "out/", "-F", "-lg", "40", "--tpu-stdout-compat", "true",
         "--tpu-engine", engine],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    _assert_golden_files(tmp_path, "h19F_trunc")

    def strip(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("Running time is")]

    with open(os.path.join(GOLDEN, "h19F_trunc", "stdout.txt")) as f:
        assert strip(r.stdout) == strip(f.read())


@pytest.mark.parametrize("fast_sim,rna_file", [(True, "H19.fa"),
                                               (False, "H19t.fa")])
def test_long_target_matches_jax(fast_sim, rna_file):
    """One DNA record (testDNAt) against H19 (-F: its truncated record)
    through both packages' long_target: the same triplexes, every field
    equal."""
    _, rna = fasta.read_rna(os.path.join(ORACLE, rna_file))
    dna = fasta.read_dna(os.path.join(ORACLE, "testDNAt.fa"))[0].seq
    p = Params(do_fast_sim=fast_sim)
    got = pipeline.long_target(p, rna, dna,
                               engine=TorchScanEngine(rna, device="cpu"))
    want = jax_pipeline.long_target(p, rna, dna)
    assert got, "no triplexes: the comparison would be empty"
    assert ([dataclasses.astuple(t) for t in got]
            == [dataclasses.astuple(t) for t in want])


def test_fast_sim_native_matches_python_model():
    """The port's native fastSIM pair stage (`_fast_sim`, its own g++
    build) equals its golden Python model (`_fast_sim_py`: peaks, Iden
    sweep, native ssw_align, convert, dedup) on real pairs."""
    from fasim_tpu_torch import rules

    _, rna = fasta.read_rna(os.path.join(ORACLE, "H19t.fa"))
    seg = fasta.read_dna(os.path.join(ORACLE, "testDNAt.fa"))[0].seq
    scans = rules.scan_list(0, 0)[:6]
    pairs = [rules.make_scan_strings(seg, s) for s in scans]
    thresh, colmax = numpy_engine(rna, [s2 for s2, _ in pairs])
    p = Params()
    n_hits = 0
    for k, sc in enumerate(scans):
        got, want = [], []
        args = (rna, pairs[k][0], pairs[k][1], 0, int(int(thresh[k]) * 0.8),
                colmax[k], sc["strand"], sc["para"], sc["rule"], p)
        pipeline._fast_sim(*args, got)
        pipeline._fast_sim_py(*args, want)
        assert ([dataclasses.astuple(t) for t in got]
                == [dataclasses.astuple(t) for t in want]), k
        n_hits += len(got)
    assert n_hits > 0


def test_default_engine_is_cuda(monkeypatch):
    """With no engine the per-segment path takes cuda:0 and raises where
    there is no device; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rna = np.frombuffer(b"ACGTACGT", np.uint8).copy()
    with pytest.raises(RuntimeError, match="is_available"):
        pipeline.long_target(Params(), rna, rna)
