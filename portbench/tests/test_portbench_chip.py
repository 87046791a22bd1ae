"""On the card: one short run of every cell, correct, with every metric
its manifest entry names.  Run there with `python3 -m pytest
portbench/tests -m chip`."""

import json
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.manifest()


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "4294967311", "--seconds", "3",
                        "--trace", str(trace)], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], r.stderr[-3000:]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[section]
            if cell in m.get("workloads", [cell])}
    assert want <= set(res["metrics"]), res["metrics"]
