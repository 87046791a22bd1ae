"""On the card: one short run of every cell, correct, with every metric
its manifest entry names, on as many cards as the cell asks for (a cell
that asks for more than the machine shows skips).  Run there with
`python3 -m pytest portbench/tests -m chip`."""

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
    chips = {w["name"]: w["chips"] for w in BENCH["workloads"]}[cell]
    if chips > torch.cuda.device_count():
        pytest.skip(f"the cell asks for {chips} GPUs; this machine shows "
                    f"{torch.cuda.device_count()}")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "4294967311", "--seconds", "3",
                        "--trace", str(trace)], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], r.stderr[-3000:]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == chips
    assert len(res["device"]["memory_peak_bytes_by_card"]) == chips
    if trace:
        assert res["device"]["busy_s"] > 0
        assert res["device"]["busy_s"] <= res["device"]["window_s"] * chips
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[section]
            if cell in m.get("workloads", [cell])}
    assert want <= set(res["metrics"]), res["metrics"]
