"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program under test (top-level module
names compared whole: fasim_tpu_torch begins with fasim_tpu)."""

import subprocess
import sys

from portbench import harness

PROBE = """
import sys
sys.path.insert(0, {root!r})
import {mod}
tops = {{m.split('.')[0] for m in sys.modules}}
print(sorted(tops & {{'jax', 'jaxlib', 'flax', 'fasim_tpu', 'fasim_tpu_torch'}}))
"""


def loaded(mod: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(harness.ROOT),
                                            mod=mod)],
        capture_output=True, text=True, check=True).stdout
    return eval(out.strip().splitlines()[-1])


def test_the_reference_loads_neither_jax_nor_the_program():
    for mod in ("portbench.reference.fastsim", "portbench.reference.output",
                "portbench.check", "portbench.control"):
        assert loaded(mod) == [], mod


def test_the_harness_and_the_program_load_no_jax():
    got = loaded("portbench.harness, portbench.trace, fasim_tpu_torch.cli, "
                 "fasim_tpu_torch.scan.batched")
    assert got == ["fasim_tpu_torch"]


def test_a_forbidden_module_is_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "fasim_tpu", object())
    assert harness.loaded_forbidden() == ["fasim_tpu"]
    monkeypatch.delitem(sys.modules, "fasim_tpu")
    monkeypatch.setitem(sys.modules, "fasim_tpu_torch", object())
    assert "fasim_tpu" not in harness.loaded_forbidden()


def test_run_py_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "neat1_peaks.peaks64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


def test_run_py_fails_without_a_gpu():
    """Here, with the program but no GPU: no result, another code than 0
    (on a GPU machine this test has nothing to check)."""
    import torch

    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "neat1_peaks.peaks64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
