"""The port's multi-host runner without a cluster: two processes of
`python -m fasim_tpu_torch.dist.runner --tpu-engine torch` on localhost,
joined by gloo over loopback.  Process 0's output files must be
byte-identical to the committed goldens (and so to a single-host run),
and a rerun from the checkpoint spills must reproduce them with no
segment scanned again (the counterpart of tests/test_multihost.py)."""

import filecmp
import os
import shutil
import socket
import subprocess
import sys

from conftest import ORACLE, REPO

GOLDEN = os.path.join(ORACLE, "golden", "meg3_sub3")

# the runner's entry, with the batches each process dispatched on stderr
_RUN = """
import sys

from fasim_tpu_torch.dist import runner
from fasim_tpu_torch.kernels.engine import TorchScanEngine

batches = []
packed = TorchScanEngine.scan_segments_packed


def counted(self, *args, **kw):
    batches.append(1)
    return packed(self, *args, **kw)


TorchScanEngine.scan_segments_packed = counted
rc = runner.main(sys.argv[1:])
print(f"BATCHES {len(batches)}", file=sys.stderr)
sys.exit(rc)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nproc: int, tmp_path, ckpt: str) -> list[int]:
    """Run nproc runner processes; the batches each one dispatched.  A
    port another process took between `_free_port` and the rendezvous is
    replaced by a fresh one (at most three tries)."""
    for _ in range(3):
        port = _free_port()
        procs = []
        for pid in range(nproc):
            env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                       FASIM_COORD=f"127.0.0.1:{port}",
                       FASIM_NPROC=str(nproc), FASIM_PID=str(pid),
                       FASIM_HOST_THREADS="2", FASIM_CKPT=ckpt,
                       GLOO_SOCKET_IFNAME="lo")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RUN, "-f1", "meg3sub3.fa", "-f2",
                 "MEG3.fa", "-O", "out/", "--tpu-engine", "torch"],
                cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [pr.communicate(timeout=600)[0] for pr in procs]
        if not any("EADDRINUSE" in t or "ddress already in use" in t
                   for t in outs):
            break
    for pr, text in zip(procs, outs):
        assert pr.returncode == 0, text[-3000:]
    assert "finished normally" in outs[0]
    return [int(next(ln.split()[1] for ln in t.splitlines()
                     if ln.startswith("BATCHES "))) for t in outs]


def _assert_golden(outdir):
    expected = sorted(f for f in os.listdir(GOLDEN) if f != "stdout.txt")
    assert sorted(os.listdir(outdir)) == expected
    for name in expected:
        assert filecmp.cmp(outdir / name, os.path.join(GOLDEN, name),
                           shallow=False), f"{name} differs"


def test_runner_loopback_byte_identical_and_resumes(tmp_path):
    for f in ("meg3sub3.fa", "MEG3.fa"):
        shutil.copy(os.path.join(ORACLE, f), tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    ckpt = str(tmp_path / "ckpt")
    # meg3sub3's 3 segments: 0 and 2 on process 0, 1 on process 1
    assert _launch(2, tmp_path, ckpt) == [1, 1]
    _assert_golden(out)
    spills = sorted(os.listdir(ckpt))
    assert spills == ["torch-host0-spill000000.pkl",
                      "torch-host1-spill000000.pkl"]
    # resume: wipe the outputs, rerun from the checkpoint spills only
    for f in os.listdir(out):
        os.unlink(out / f)
    assert _launch(2, tmp_path, ckpt) == [0, 0]
    assert sorted(os.listdir(ckpt)) == spills
    _assert_golden(out)
