"""End to end through the port's CLI (`python -m fasim_tpu_torch.cli
--tpu-engine torch`, the kernels' plain versions on the CPU): output
files byte-identical to the committed goldens, stdout too except the
`Running time is` line (as tests/test_e2e_golden.py checks the JAX
package), with the batched driver and, on two goldens, the streaming
one.  Also: the port never loads jax, and the CUDA engine raises
without a device instead of falling back to the CPU."""

import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import ORACLE

GOLDEN = os.path.join(ORACLE, "golden")
REPO = os.path.dirname(ORACLE)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "2"  # six xdist workers share the box
    return env


@pytest.mark.parametrize("case,f1,f2,extra", [
    ("h19_lg40", "testDNA.fa", "H19.fa", ["-lg", "40"]),
    ("h19_default", "testDNA.fa", "H19.fa", []),
    ("meg3_sub3", "meg3sub3.fa", "MEG3.fa", []),
    ("neat1t", "testDNA.fa", "NEAT1t.fa", []),
])
def test_port_cli_byte_identical(tmp_path, case, f1, f2, extra):
    _check_cli(tmp_path, case, f1, f2, extra, {})


def test_port_cli_switch_paths_byte_identical(tmp_path):
    """FASIM_SCAN16=1 FASIM_WIN_V1=1: the scan passes on K7's plain
    version and every window pass on K6's."""
    _check_cli(tmp_path, "h19_lg40", "testDNA.fa", "H19.fa", ["-lg", "40"],
               {"FASIM_SCAN16": "1", "FASIM_WIN_V1": "1"})


@pytest.mark.parametrize("case,f1,f2,extra", [
    ("h19F_trunc", "testDNAt.fa", "H19t.fa", ["-F", "-lg", "40"]),
    ("meg3_sub3", "meg3sub3.fa", "MEG3.fa", []),
])
def test_port_cli_stream_byte_identical(tmp_path, case, f1, f2, extra):
    """The streaming driver (`--tpu-stream on`): the goldens byte for byte,
    and no spill file left behind in FASIM_SPILL_DIR."""
    spill = tmp_path / "spill"
    spill.mkdir()
    _check_cli(tmp_path, case, f1, f2, [*extra, "--tpu-stream", "on"],
               {"FASIM_SPILL_DIR": str(spill)})
    assert os.listdir(spill) == []


@pytest.mark.parametrize("extra,env", [
    ([], {"FASIM_SIM_DEVICE": "1"}),
    (["--tpu-sim-device", "true"], {}),
    (["--tpu-sim-device", "true", "--tpu-stream", "on"], {}),
], ids=["switch", "flag", "flag-stream"])
def test_port_cli_sim_device_byte_identical(tmp_path, extra, env):
    """`-F` with the forward scan on the engine's device (K8's plain
    version on the CPU) and the host replay: the golden byte for byte,
    under FASIM_SIM_DEVICE=1, under --tpu-sim-device true, and under the
    flag through the streaming driver."""
    spill = tmp_path / "spill"
    spill.mkdir()
    _check_cli(tmp_path, "h19F_trunc", "testDNAt.fa", "H19t.fa",
               ["-F", "-lg", "40", *extra],
               dict(env, FASIM_SPILL_DIR=str(spill)))
    assert os.listdir(spill) == []


def _check_cli(tmp_path, case, f1, f2, extra, env):
    golden_dir = os.path.join(GOLDEN, case)
    shutil.copy(os.path.join(ORACLE, f1), tmp_path)
    shutil.copy(os.path.join(ORACLE, f2), tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    r = subprocess.run(
        [sys.executable, "-m", "fasim_tpu_torch.cli", "-f1", f1, "-f2", f2,
         "-O", "out/", "--tpu-stdout-compat", "true", "--tpu-engine",
         "torch", *extra],
        cwd=tmp_path, env=dict(_env(), **env), check=True,
        capture_output=True, timeout=600)
    produced = sorted(os.listdir(out))
    # the golden's one stdout file: stdout.txt, or stdout_<case>.txt
    [stdout] = [f for f in os.listdir(golden_dir) if f.startswith("stdout")]
    expected = sorted(f for f in os.listdir(golden_dir) if f != stdout)
    assert produced == expected
    for name in expected:
        assert filecmp.cmp(out / name, os.path.join(golden_dir, name),
                           shallow=False), f"{case}/{name} differs"

    def strip(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("Running time is")]

    with open(os.path.join(golden_dir, stdout)) as f:
        assert strip(r.stdout.decode()) == strip(f.read()), case


_NO_JAX = """
import sys
import numpy as np
import fasim_tpu_torch.cli
import fasim_tpu_torch.scan.batched
from fasim_tpu_torch import rules
from fasim_tpu_torch.kernels import _build, engine, pack, scan, window
eng = engine.TorchScanEngine(np.frombuffer(b"ACGTACGGTA", np.uint8).copy(),
                             device="cpu")
eng.setup_scans(rules.scan_list(0, 0))
eng.setup_windows(np.frombuffer(b"ACGTACGGTA", np.uint8).copy())
segs = np.frombuffer(b"TTACGTACGGTAGG" * 4, np.uint8).reshape(1, -1).copy()
out = eng.scan_segments_packed(segs, np.array([segs.shape[1]], np.int32))
assert int(out[0].max()) > 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""


def test_port_never_imports_jax():
    r = subprocess.run([sys.executable, "-c", _NO_JAX], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("engine", ["cuda", "auto"])
def test_cuda_engine_raises_without_device(engine, monkeypatch):
    """`cuda` (and `auto`) never pick the CPU silently."""
    import torch

    from fasim_tpu_torch import cli
    from fasim_tpu_torch.config import TpuConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.make_engine(TpuConfig(engine=engine),
                        np.frombuffer(b"ACGT", np.uint8).copy())


def test_engine_defaults_to_cuda(monkeypatch):
    """TorchScanEngine(rna) means cuda:0: without a device it raises, and
    the CPU is taken only when asked for."""
    import torch

    from fasim_tpu_torch.kernels.engine import TorchScanEngine

    rna = np.frombuffer(b"ACGT", np.uint8).copy()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TorchScanEngine(rna)
    assert TorchScanEngine(rna, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("flag", ["--tpu-dtype", "--tpu-interpret",
                                  "--tpu-unroll"])
def test_tpu_kernel_flags_are_unknown(flag):
    """The JAX package's knobs of its TPU kernels have no counterpart in
    the port: its CLI rejects them instead of ignoring them."""
    from fasim_tpu_torch import cli

    with pytest.raises(SystemExit, match="unknown flag"):
        cli.parse_args(["-f1", "a.fa", flag, "1"])


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tpu_dp_devices_flag(n, monkeypatch, tmp_path):
    """--tpu-dp-devices N, a flag of the reference's help (fasim_tpu/cli.py):
    the CLI builds one engine a device and hands the list to the batched
    driver, which round-robins its batches over them.  cuda: the first N
    devices this process sees, 0 meaning every one (two with a patched
    device_count; one on a box with one card, as the JAX package's
    devices[:N]); torch: max(1, N) engines on the CPU.  The engine and
    the driver are stand-ins: nothing is scanned; the empty DNA file is
    there for `--tpu-stream auto` to read its size."""
    from fasim_tpu_torch import cli
    from fasim_tpu_torch.kernels import engine as engine_mod
    from fasim_tpu_torch.scan import batched

    dna = tmp_path / "a.fa"
    dna.touch()
    argv = ["-f1", str(dna), "-f2", "b.fa", "--tpu-dp-devices", str(n)]
    assert cli.parse_args(argv)[1].dp_devices == n
    assert cli.parse_args(argv[:4])[1].dp_devices == 0
    made, driven = [], []

    class Engine:
        def __init__(self, rna, device):
            made.append(device)

    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(engine_mod, "TorchScanEngine", Engine)
    monkeypatch.setattr(batched, "scan_file_batched",
                        lambda p, eng, **kw: driven.append(eng))
    monkeypatch.setattr(cli, "run", lambda p, tpu, scan: scan(p, None) or 0)
    for cards, engine, want in (
            (2, "cuda", ["cuda:0", "cuda:1"][:n or 2]),
            (1, "cuda", ["cuda:0"]),
            (2, "torch", ["cpu"] * max(1, n))):
        made.clear()
        driven.clear()
        monkeypatch.setattr(cli.torch.cuda, "device_count", lambda: cards)
        assert cli.main([*argv, "--tpu-engine", engine]) == 0
        assert made == want, (cards, engine)
        assert len(driven) == 1 and len(driven[0]) == len(want)


def test_torch_engine_is_cpu():
    from fasim_tpu_torch import cli
    from fasim_tpu_torch.config import TpuConfig

    [eng] = cli.make_engine(TpuConfig(engine="torch"),
                            np.frombuffer(b"ACGT", np.uint8).copy())
    assert eng.device.type == "cpu"
    assert cli.make_engine(TpuConfig(engine="numpy"), None) is None
