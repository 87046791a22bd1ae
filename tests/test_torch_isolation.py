"""The port stands alone: with `jax` and the JAX package `fasim_tpu`
blocked at import, every module of `fasim_tpu_torch` and `chip_smoke`
imports, and a scan, a window pass, the numpy_engine call, the
per-segment pipeline, a `-F` scan, the streaming driver with its
columnar store, a batched scan under FASIM_SCAN16=1 FASIM_WIN_V1=1, a
batched `-F` scan under FASIM_SIM_DEVICE=1 (the device forward scan of
kernels/sim_dev.py and the native replay), the round-robin over two
engines, the sharded scan step of `dist` and the runner's spill loader
(`dist/runner.py`), and `iter_scan_work` with prewarm on for a stand-in
card engine (scan/prewarm.py) run on the CPU; the GPU parity matrix
(`fasim_tpu_torch.verify`) imports."""

import os
import subprocess
import sys

from conftest import ORACLE

REPO = os.path.dirname(ORACLE)

_ISOLATED = r"""
import importlib
import importlib.abc
import pkgutil
import sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "fasim_tpu"):
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None


sys.meta_path.insert(0, Block())

import numpy as np

import fasim_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(fasim_tpu_torch.__path__,
                                              "fasim_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its main() is not run)

from fasim_tpu_torch import rules
from fasim_tpu_torch.config import Params
from fasim_tpu_torch.kernels.engine import TorchScanEngine
from fasim_tpu_torch.scan import batched, pipeline

rng = np.random.default_rng(3)
dna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 300)].copy()
# one strong hit: the query pairs with dna[100:160] under scan 0's rule
# (no T run in the source, which the stability score penalizes)
dna[100:160] = np.frombuffer(b"ACG", np.uint8)[rng.integers(0, 3, 60)]
scans = rules.scan_list(0, 0)[:4]
sc = scans[0]
rna = rules.transfer_lut(sc["strand"], sc["para"], sc["rule"])[dna[100:160]]
eng = TorchScanEngine(rna, device="cpu")
eng.setup_scans(scans)
eng.setup_windows(rna)
segs = dna[None, :256].copy()
out = eng.scan_segments_packed(segs, np.array([256], np.int32))
assert int(out[0].max()) > 0
ends = eng.window_pass(np.zeros((2, 64), np.uint8), np.zeros(2, np.int32),
                       np.full(2, -1, np.int32), np.full(2, 60, np.int32),
                       np.full(2, 48, np.int32), rev=False)
assert ends.shape == (2, 3)
seq2 = [rules.make_scan_strings(dna, s)[0] for s in scans]
thresh, colmax = eng(rna, seq2)
assert thresh.shape == (4,) and colmax.shape == (4, 300)
hits = pipeline.long_target(Params(), rna, dna, engine=eng)
hits_f = pipeline.long_target(Params(do_fast_sim=False), rna, dna,
                              engine=eng)
work, _ = batched.enumerate_work(Params(do_fast_sim=False),
                                 [type("R", (), {"seq": dna})()])
batched.scan_work(Params(do_fast_sim=False), rna, work, scans, eng)
assert hits and hits_f, (len(hits), len(hits_f))
# the streaming driver and its columnar store, through the output writer
import os
import tempfile

from fasim_tpu_torch.post.output import print_result

home = os.getcwd()
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)  # output names embed the -f1 path
    with open("d.fa", "w") as f:
        f.write(">sp|chr1|1-300\n" + dna.tobytes().decode() + "\n")
    with open("r.fa", "w") as f:
        f.write(">q\n" + rna.tobytes().decode() + "\n")
    p = Params(file1path="d.fa", file2path="r.fa", outpath=".")
    _, _, _, tl = batched.scan_file_batched(p, eng)
    metas, lnc, _, store = batched.scan_file_stream(p, eng,
                                                    spill_dir="spill")
    assert [m.seq_len for m in metas] == [300]
    assert len(store) == len(tl) > 0, (len(store), len(tl))
    print_result(p, metas[0].species, lnc, store, metas[0].chro_tag,
                 metas[0].seq_len, metas[0].start_genome)
    assert os.listdir("spill") == []
    assert os.path.getsize("sp-q-d-TFOsorted") > 0
    os.chdir(home)
# the switch paths (K7 and K6 plain versions) give the default path's hits

rec = [type("R", (), {"seq": dna})()]
want = batched.scan_records(Params(), rec, rna, eng)
os.environ.update(FASIM_SCAN16="1", FASIM_WIN_V1="1")
eng16 = TorchScanEngine(rna, device="cpu")
got = batched.scan_records(Params(), rec, rna, eng16)
assert eng16.scan16 and eng16.win_v1
assert want[0] and got == want, (len(got[0]), len(want[0]))
# -F with the forward scan on the device (K8's plain version on the CPU)
# and the native replay gives the host SIM's hits
os.environ.update(FASIM_SCAN16="0", FASIM_WIN_V1="0")
pf = Params(do_fast_sim=False)
want_f = batched.scan_records(pf, rec, rna, eng)
calls = []
cells_fn = batched.sim_forward_cells
batched.sim_forward_cells = lambda *a: calls.append(a[3]) or cells_fn(*a)
os.environ["FASIM_SIM_DEVICE"] = "1"
got_f = batched.scan_records(pf, rec, rna, eng)
os.environ["FASIM_SIM_DEVICE"] = "0"
assert calls and all(str(d) == "cpu" for d in calls), calls
assert want_f[0] and got_f == want_f, (len(got_f[0]), len(want_f[0]))
# multi-device: dist, its runner and dry run import; the round-robin
# over two engines gives one engine's hits; the sharded step and the
# runner's payload loader run
import pickle

from fasim_tpu_torch import dist
from fasim_tpu_torch.dist import dryrun, runner

assert {"fasim_tpu_torch.dist", "fasim_tpu_torch.dist.runner",
        "fasim_tpu_torch.dist.dryrun"} <= set(mods), mods
recs2 = [type("R", (), {"seq": dna})(),
         type("R", (), {"seq": dna[::-1].copy()})()]
one = batched.scan_records(Params(), recs2, rna, eng, batch_pairs=1)
two = batched.scan_records(Params(), recs2, rna,
                           [eng, TorchScanEngine(rna, device="cpu")],
                           batch_pairs=1)
assert one[0] and two == one, (len(two[0]), len(one[0]))
codes = rules.SSW_ENC[np.stack(seq2)][None]
th, cm = dist.sharded_scan_step(dist.make_mesh(1, 2, ["cpu"] * 2),
                                rna)(codes, codes)
assert th.shape == (1, 4) and cm.shape == (1, 4, 300)
assert runner._loads(pickle.dumps(hits_f)) == hits_f
# prewarm: a stand-in card engine (a CPU engine that reports cuda:0)
# through iter_scan_work with prewarm on, window warm included; the
# kernel library's build and the device scope are stubbed (no nvcc, no
# card); the GPU parity matrix imports
import contextlib

import torch

import fasim_tpu_torch.verify  # noqa: F401
from fasim_tpu_torch.scan import prewarm

assert {"fasim_tpu_torch.verify", "fasim_tpu_torch.scan.prewarm"} <= set(
    mods), mods


class FakeCuda:
    def __init__(self, rna):
        self.inner = TorchScanEngine(rna, device="cpu")
        self.device = torch.device("cuda:0")
        self.warmed, self.warm_jobs = set(), []

    def __getattr__(self, name):
        return getattr(self.inner, name)


warm_jobs = []
scan_job, window_job = prewarm._scan_job, prewarm._window_job
prewarm._kernel_library = lambda: None
prewarm._on_device = lambda device: contextlib.nullcontext()
prewarm._scan_job = lambda *a: warm_jobs.append("scan") or scan_job(*a)
prewarm._window_job = lambda *a: warm_jobs.append("win") or window_job(*a)
os.environ["FASIM_PREWARM"] = "1"
fake = FakeCuda(rna)
work2, scans48 = batched.enumerate_work(Params(), recs2)
warm = list(batched.iter_scan_work(Params(), rna, iter(work2), scans48,
                                   fake, 384, batch_pairs=1))
assert warm_jobs == ["scan", "win"], warm_jobs
assert fake.warmed == {(384, 1)} and fake.warm_jobs == []
assert [h for _, h in warm] == one, (len(warm), len(one))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "fasim_tpu"))
assert not bad, bad
print("ok", len(mods))
"""


def test_port_runs_with_jax_and_fasim_tpu_blocked():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.startswith("ok"), r.stdout
