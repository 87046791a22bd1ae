"""The port's GPU parity matrix (fasim_tpu_torch/verify.py) and the flag
cases' expected outputs (oracle/jax_expected/) on the CPU.

The case table covers every expected-output directory and every route's
kernels are wrappers of the shared table; every flag case with at most
12 transforms matches its expected files byte for byte, stdout too but
"Running time is", through the JAX package's CLI (`--tpu-engine xla`,
where the files came from) and through the port's CLI (`--tpu-engine
torch`, the kernels' plain versions) in verify's own child and parent
machinery: default, under FASIM_SCAN16=1 FASIM_WIN_V1=1 and, for
flags_F_r2, under FASIM_SIM_DEVICE=1.  A copy of the expected files with
one byte changed makes `python -m fasim_tpu_torch.verify` exit non-zero
with a record that names the file."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ORACLE
from fasim_tpu_torch import ab_cli, cli, rules, verify
from fasim_tpu_torch.kernels import WRAPPERS

REPO = os.path.dirname(ORACLE)
EXPECTED = os.path.join(ORACLE, "jax_expected")
# the flag cases of at most 12 transforms (MANIFEST.json's "transforms")
SMALL = ("flags_r1", "flags_r3_t1", "flags_t1", "flags_F_r2")


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # six xdist workers share


def _manifest() -> dict:
    with open(os.path.join(EXPECTED, "MANIFEST.json")) as f:
        return json.load(f)


def test_case_table_covers_every_expected_directory():
    """Every directory of oracle/golden/ and oracle/jax_expected/ is a case
    held against it, the lists split the cases, verify_tpu's FAST and
    FULL cases are there with their flags, and the flag cases are
    MANIFEST.json's with its transform counts."""
    for where in ("golden", "jax_expected"):
        dirs = sorted(d for d in os.listdir(os.path.join(ORACLE, where))
                      if os.path.isdir(os.path.join(ORACLE, where, d)))
        assert dirs == sorted(c for c, v in verify.CASES.items()
                              if v[3] == where)
    lists = verify.FAST + verify.FLAGS + verify.FULL
    assert sorted(lists) == sorted(verify.CASES)
    spec = importlib.util.spec_from_file_location(
        "verify_tpu", os.path.join(REPO, "scripts", "verify_tpu.py"))
    tpu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tpu)
    assert [c[0] for c in tpu.FAST_CASES] == list(verify.FAST)
    for case, f1, f2, extra in tpu.FAST_CASES + tpu.FULL_CASES:
        assert verify.CASES[case][:3] == (f1, f2, extra)
    cases = _manifest()["cases"]
    assert sorted(cases) == sorted(verify.FLAGS)
    for case, entry in cases.items():
        f1, f2, flags, _ = verify.CASES[case]
        assert (f1, f2, flags) == (entry["dna"], entry["rna"],
                                   entry["flags"])
        p, _ = cli.parse_args(["-f1", f1, "-f2", f2, *flags])
        assert len(rules.scan_list(p.rule, p.strand)) == entry["transforms"]
    assert {c for c in cases if cases[c]["transforms"] <= 12} == set(SMALL)


@pytest.mark.parametrize("case", sorted(verify.CASES))
def test_every_route_names_wrappers(case):
    """Each route of a case is a route of the table and expects kernels
    of the shared wrapper table (the long forms never); -F cases go to
    K8, fastSIM ones to K4 alone under FASIM_WIN_V3=0."""
    routes = verify.routes_of(case)
    assert set(routes) <= set(verify.ROUTES)
    assert ("sim_device" in routes) == verify.exact_sim(case)
    assert ("win_v3_off" in routes) != verify.exact_sim(case)
    for route in routes:
        for escalations in (0, 1):
            on = verify.expected_kernels(case, route, escalations)
            assert on and on <= set(WRAPPERS) - {"window_general_long",
                                                 "window_v1_long"}


@pytest.mark.parametrize("case", SMALL)
def test_jax_cli_writes_the_expected_files(case):
    """The JAX package's CLI (XLA engine on the CPU) writes the committed
    expected files: where they came from."""
    f1, f2, flags, _ = verify.CASES[case]
    res = ab_cli.run_once(
        REPO, (f1, f2), verify.expected_dir(case),
        ["-f1", f1, "-f2", f2, "-O", "out/", *flags, "--tpu-engine", "xla",
         "--tpu-stdout-compat", "true"], {"JAX_PLATFORMS": "cpu"},
        module="fasim_tpu.cli")
    assert res["rc"] == 0, res["stderr"][-2000:]
    assert res["differ"] == []


@pytest.mark.parametrize("case,route", [
    *((c, r) for c in SMALL for r in ("default", "switched")),
    ("flags_F_r2", "sim_device"),
])
def test_port_matches_through_the_matrix(case, route):
    """One run of the matrix on the CPU, through verify's child process
    and the parent's checks: the port's CLI writes the expected files and
    stdout, and the record says so."""
    rec = verify.run_case(case, route, device="cpu")
    assert rec["ok"], rec.get("why")
    assert (rec["identical"], rec["rc"], rec["differ"]) == (True, 0, [])
    assert (rec["case"], rec["route"], rec["device"]) == (case, route, "cpu")
    # the plain versions launch no kernel; a CPU engine is not warmed
    assert set(rec["launches"]) == set(WRAPPERS)
    assert not any(rec["launches"].values())
    assert rec["prewarm_launches"] == 0
    assert 0 < rec["first_batch_s"] <= rec["wall"]
    assert rec["stages"]["wall"] > 0


def test_changed_byte_fails_the_matrix(tmp_path):
    """The parent exits non-zero and its record names the file whose byte
    was changed."""
    case = "flags_r1"
    copy = tmp_path / "expected" / case
    shutil.copytree(verify.expected_dir(case), copy)
    [sorted_name] = [f for f in os.listdir(copy)
                     if f.endswith("TFOsorted")]
    data = bytearray((copy / sorted_name).read_bytes())
    i = data.index(b"\n") + 1  # the first row after the header
    data[i] = ord("9") if data[i] != ord("9") else ord("8")
    (copy / sorted_name).write_bytes(bytes(data))
    out = tmp_path / "records.json"
    r = subprocess.run(
        [sys.executable, "-m", "fasim_tpu_torch.verify", "--device", "cpu",
         "--case", case, "--route", "default", "--expected",
         str(tmp_path / "expected"), "--json", str(out)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 1, r.stderr[-2000:]
    [rec] = json.loads(out.read_text())
    assert rec["differ"] == [sorted_name]
    assert not rec["ok"] and not rec["identical"]
    summary = json.loads(r.stdout.splitlines()[-1])
    assert summary["failed"] == [f"{case}/default"]
