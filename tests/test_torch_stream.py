"""The port's streaming driver (`scan_file_stream`, lazy records and the
columnar hit store) held on the CPU against the port's batched driver
and the JAX package's `scan_file_stream`, exactly: equal record metadata,
equal frozen store columns, byte-identical output files through
`print_result`; at `-C` 1, 2 and 3 with the alignment strings spilled and
in RAM, and for a record that spans several batches; `-C` 2 and 3
through the port's CLI (`cli.main`), both drivers, against the JAX
package's CLI.  Also the watchdog of `iter_scan_work`, and the CLI's
choice of driver (`wants_stream`).  The runs over one input share a
`MemoEngine`, so each distinct device call is computed once; the
subprocess runs of tests/test_torch_e2e.py take the CLI's own engine."""

import dataclasses
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from conftest import ORACLE

import fasim_tpu.cli as jax_cli
from fasim_tpu.config import Params as JaxParams
from fasim_tpu.kernels.xla import XlaScanEngine
from fasim_tpu.post.output import print_result as jax_print_result
from fasim_tpu.scan import batched as jax_batched

from fasim_tpu_torch import cli, rules
from fasim_tpu_torch.config import Params, TpuConfig
from fasim_tpu_torch.io import fasta
from fasim_tpu_torch.kernels.engine import TorchScanEngine
from fasim_tpu_torch.post.output import print_result
from fasim_tpu_torch.scan import batched

_CACHE: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # six xdist workers share the box
    yield
    torch.set_num_threads(prev)


def _key(x):
    """A hashable key of an engine call's argument, by content."""
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if hasattr(x, "shape") and hasattr(x, "dtype"):  # numpy, torch, jax
        a = np.asarray(x.cpu() if hasattr(x, "cpu") else x)
        return a.shape, str(a.dtype), a.tobytes()
    return x


def _copy(x):
    if isinstance(x, tuple):
        return tuple(_copy(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.copy()
    return x.clone() if hasattr(x, "clone") else x  # jax arrays are immutable


class MemoEngine:
    """A scan engine that computes each distinct call once.  The scan is
    deterministic, so the runs of a test over one input (the -C buckets,
    the spill, the other driver) get the device results they would
    compute; a call with other arguments (another batch, another width)
    is computed anew.  What the runs differ in is the drivers' and the
    store's own code, which runs in full every time."""

    def __init__(self, engine):
        self._engine = engine
        self._memo: dict = {}

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if not callable(attr) or name.startswith("setup_"):
            return attr

        def call(*args, **kw):
            key = (name, _key(args), _key(kw))
            if key not in self._memo:
                self._memo[key] = attr(*args, **kw)
            return _copy(self._memo[key])

        return call


def engines(rna) -> tuple:
    """One memoizing port engine (the plain versions on the CPU) and one
    memoizing JAX XlaScanEngine for this query, shared by the module."""
    key = ("engines", rna.tobytes())
    if key not in _CACHE:
        _CACHE[key] = (MemoEngine(TorchScanEngine(rna, device="cpu")),
                       MemoEngine(XlaScanEngine(rna)))
    return _CACHE[key]


def _outputs(outdir, printer, p, first, lnc, hits) -> dict:
    """Output files (name -> bytes) of one run through `printer`."""
    os.makedirs(outdir, exist_ok=True)
    p = dataclasses.replace(p, outpath=str(outdir))
    size = getattr(first, "seq_len", None)
    printer(p, first.species, lnc, hits, first.chro_tag,
            len(first.seq) if size is None else size, first.start_genome)
    return {f: (outdir / f).read_bytes() for f in sorted(os.listdir(outdir))}


def _port_batched(tmp_factory, corenum: int):
    """The port's batched driver on meg3sub3 x MEG3 at -C corenum (one
    run per corenum for the whole module)."""
    key = ("port_batched", corenum)
    if key not in _CACHE:
        p = Params(file1path="meg3sub3.fa", file2path="MEG3.fa",
                   corenum=corenum)
        _, rna = fasta.read_rna(p.file2path)
        recs, lnc, _, hits = batched.scan_file_batched(
            p, engines(rna)[0], batch_pairs=3, host_threads=2)
        assert hits
        out = _outputs(tmp_factory.mktemp("batched"), print_result, p,
                       recs[0], lnc, hits)
        _CACHE[key] = (recs, out)
    return _CACHE[key]


def _jax_stream(tmp_factory, corenum: int):
    """The JAX package's scan_file_stream (XlaScanEngine on the CPU):
    record metadata, frozen store columns, output files."""
    key = ("jax_stream", corenum)
    if key not in _CACHE:
        p = JaxParams(file1path="meg3sub3.fa", file2path="MEG3.fa",
                      corenum=corenum)
        _, rna = fasta.read_rna(p.file2path)
        metas, lnc, _, store = jax_batched.scan_file_stream(
            p, engines(rna)[1], batch_pairs=3, host_threads=2,
            spill_dir=str(tmp_factory.mktemp("jax_spill")))
        cols = {k: v.copy() for k, v in store.cols.items()}
        out = _outputs(tmp_factory.mktemp("jax"), jax_print_result, p,
                       metas[0], lnc, store)
        _CACHE[key] = (metas, cols, out)
    return _CACHE[key]


@pytest.mark.parametrize("spill", [True, False], ids=["spill", "ram"])
@pytest.mark.parametrize("corenum", [1, 2, 3])
def test_stream_matches_batched_and_jax(tmp_path, tmp_path_factory,
                                        monkeypatch, corenum, spill):
    monkeypatch.chdir(ORACLE)  # output names embed the -f1 path
    monkeypatch.setenv("FASIM_PREWARM", "0")  # the JAX engine's compiles
    recs, want = _port_batched(tmp_path_factory, corenum)
    jax_metas, jax_cols, jax_out = _jax_stream(tmp_path_factory, corenum)

    p = Params(file1path="meg3sub3.fa", file2path="MEG3.fa",
               corenum=corenum)
    _, rna = fasta.read_rna(p.file2path)
    spill_dir = tmp_path / "spill"
    metas, lnc, _, store = batched.scan_file_stream(
        p, engines(rna)[0], batch_pairs=3, host_threads=2,
        spill_dir=str(spill_dir) if spill else "")
    assert (store._spill is not None) == spill
    assert [(m.species, m.chro_tag, m.start_genome, m.seq_len)
            for m in metas] == [(r.species, r.chro_tag, r.start_genome,
                                 len(r.seq)) for r in recs]
    assert [dataclasses.astuple(m) for m in metas] == [
        dataclasses.astuple(m) for m in jax_metas]
    assert len(store) > 0
    assert sorted(store.cols) == sorted(jax_cols)
    for k, v in jax_cols.items():
        assert store.cols[k].dtype == v.dtype, k
        assert np.array_equal(store.cols[k], v), k
    got = _outputs(tmp_path / "out", print_result, p, metas[0], lnc, store)
    if spill:
        assert os.listdir(spill_dir) == []
    assert list(got) == list(want) == list(jax_out) and len(got) == 3
    for name in got:
        assert got[name] == want[name], (corenum, spill, name)
        assert got[name] == jax_out[name], (corenum, spill, name)


def test_stream_record_spanning_batches(tmp_path, monkeypatch):
    """One batch a segment (batch_pairs=1) and a record of 2 segments
    before a record of 1: the stream flushes each record when its last
    batch is in, as the batched driver's per-record lists."""
    recs = fasta.read_dna(os.path.join(ORACLE, "meg3sub3.fa"))
    long_seq = b"".join(r.seq.tobytes() for r in recs).decode()
    with open(tmp_path / "span.fa", "w") as f:
        for head, seq in (
                (">MACS_pk13559|chrX|40362683-40369913", long_seq),
                (">MACS_pk987|chr20|5710830-5713236",
                 recs[1].seq.tobytes().decode())):
            f.write(head + "\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")
    monkeypatch.chdir(tmp_path)
    p = Params(file1path="span.fa", file2path=os.path.join(ORACLE,
                                                           "MEG3.fa"))
    work, _ = batched.enumerate_work(p, fasta.read_dna("span.fa"))
    assert [w.record_idx for w in work] == [0, 0, 1]
    _, rna = fasta.read_rna(p.file2path)
    eng = engines(rna)[0]
    b_recs, lnc, _, hits = batched.scan_file_batched(p, eng, batch_pairs=1,
                                                     host_threads=2)
    metas, lnc2, _, store = batched.scan_file_stream(
        p, eng, batch_pairs=1, host_threads=2,
        spill_dir=str(tmp_path / "spill"))
    assert [(m.chro_tag, m.seq_len) for m in metas] == [
        (r.chro_tag, len(r.seq)) for r in b_recs] == [
        ("chrX", len(long_seq)), ("chr20", len(recs[1].seq))]
    assert len(store) == len(hits) > 0
    assert store.cols["genomestart"].tolist() == [t.genomestart
                                                  for t in hits]
    want = _outputs(tmp_path / "b", print_result, p, b_recs[0], lnc, hits)
    got = _outputs(tmp_path / "s", print_result, p, metas[0], lnc2, store)
    assert got == want


def _main(main, argv, capsys) -> list:
    """One CLI run; its stdout lines without `Running time is`."""
    assert main(argv) == 0
    return [ln for ln in capsys.readouterr().out.splitlines()
            if not ln.startswith("Running time is")]


@pytest.mark.parametrize("stream", ["on", "off"])
@pytest.mark.parametrize("corenum", [2, 3])
def test_port_corenum_matches_jax_cli(tmp_path, monkeypatch, capsys,
                                      corenum, stream):
    """`-C corenum` through the port's CLI, batched and streamed: every
    output file and stdout (except `Running time is`) as the JAX package's
    CLI at the same `-C` writes them, on meg3sub3 x MEG3.  The reference's
    `-C` spawns no threads; it round-robins each DNA record's triplexes
    into corenum buckets and concatenates them (Fasim-LongTarget.cpp:
    129-163), which permutes TFOsorted rows within sort-tie classes (at
    -C 2 here; -C 3 keeps the 3 records in order).  Both CLIs run on this
    module's memoizing engines, in batches of 3 as the tests above; the
    JAX CLI streams too (its output equals its batched driver's,
    tests/test_batched_driver.py), so its device calls are the ones
    test_stream_matches_batched_and_jax made."""
    for f in ("meg3sub3.fa", "MEG3.fa"):
        shutil.copy(os.path.join(ORACLE, f), tmp_path)
    monkeypatch.chdir(tmp_path)  # output names embed the -f1 path
    _, rna = fasta.read_rna("MEG3.fa")
    port_engine, jax_engine = engines(rna)
    monkeypatch.setattr(cli, "make_engine", lambda tpu, rna: port_engine)
    monkeypatch.setattr(jax_cli, "make_engine",
                        lambda tpu, rna: [jax_engine])
    monkeypatch.setenv("FASIM_PREWARM", "0")  # the JAX engine's compiles
    spill = tmp_path / "spill"
    spill.mkdir()
    monkeypatch.setenv("FASIM_SPILL_DIR", str(spill))
    argv = ["-f1", "meg3sub3.fa", "-f2", "MEG3.fa", "-C", str(corenum),
            "--tpu-stdout-compat", "true", "--tpu-segments-per-batch", "3"]
    for d in ("jax", "port"):
        os.mkdir(d)
    want = _main(jax_cli.main, [*argv, "-O", "jax/", "--tpu-stream", "on"],
                 capsys)
    got = _main(cli.main, [*argv, "-O", "port/", "--tpu-engine", "torch",
                           "--tpu-stream", stream], capsys)
    names = sorted(os.listdir("jax"))
    assert sorted(os.listdir("port")) == names and len(names) == 3
    for name in names:
        with open(os.path.join("jax", name), "rb") as a, \
                open(os.path.join("port", name), "rb") as b:
            assert b.read() == a.read(), f"-C {corenum} {stream}: {name}"
    assert got == want
    assert os.listdir(spill) == []  # the stream's spill file is removed


class _Wedge:
    """A device tensor whose read-back never returns (a hung kernel)."""

    def __init__(self, hang: threading.Event):
        self._hang = hang

    def cpu(self):
        self._hang.wait(60)
        raise AssertionError("watchdog did not fire")


@pytest.mark.parametrize("where", ["a device batch", "a host finalize task"])
def test_watchdog_raises_on_wedged_batch(monkeypatch, where):
    """A batch whose device read-back (in its stage thread) or host
    finalize never completes surfaces as a RuntimeError naming the
    watchdog within FASIM_WATCHDOG_S, not as an indefinite hang; the
    driver does not wait for the wedged thread on its way out."""
    hang = threading.Event()
    p = Params(file1path=os.path.join(ORACLE, "testDNA.fa"),
               file2path=os.path.join(ORACLE, "H19.fa"))
    _, rna = fasta.read_rna(p.file2path)
    eng = TorchScanEngine(rna, device="cpu")

    class WedgedEngine:
        """Delegates to the real engine; the launched scan never ends."""

        def __getattr__(self, name):
            return getattr(eng, name)

        def scan_segments_packed(self, segs, lengths):
            return (_Wedge(hang),) * 5

    def wedged_finalize(p, rna, q_idx, rna_b, meta, batch, *args, **kw):
        pool = args[-1]
        return [(w, pool.submit(hang.wait, 60)) for w in batch]

    if where == "a device batch":
        engine = WedgedEngine()
    else:
        engine = eng
        monkeypatch.setattr(batched, "candidate_stage_batch",
                            wedged_finalize)
    monkeypatch.setenv("FASIM_WATCHDOG_S", "2")
    scans = rules.scan_list(0, 0)
    work = [batched._Work(0, 0, rec.seq[:640])
            for rec in fasta.read_dna(p.file1path)]
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="watchdog") as err:
            list(batched.iter_scan_work(p, rna, iter(work), scans, engine,
                                        640, batch_pairs=1,
                                        max_inflight=1))
        elapsed = time.monotonic() - t0
    finally:
        hang.set()
    assert where in str(err.value)
    assert "FASIM_CKPT" not in str(err.value)
    assert 2 <= elapsed < 2 + 8, elapsed


# The port's CLI (`cli.entry`, what `python -m fasim_tpu_torch.cli` runs)
# streaming on an engine whose device read-back never returns
WEDGED_CLI = """
import sys
import threading
import time

from fasim_tpu_torch import cli
from fasim_tpu_torch.kernels.engine import TorchScanEngine


class Wedge:
    def cpu(self):
        threading.Event().wait()  # a hung kernel: never returns


class WedgedEngine:
    def __init__(self, rna):
        self._eng = TorchScanEngine(rna, device="cpu")

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def scan_segments_packed(self, segs, lengths):
        return (Wedge(),) * 5


cli.make_engine = lambda tpu, rna: WedgedEngine(rna)
print("T0", time.monotonic(), file=sys.stderr, flush=True)
cli.entry()
"""


def test_watchdog_ends_the_cli_process(tmp_path):
    """A real hang through the CLI in its own process, the wedge never
    released: the process exits with status 1 within FASIM_WATCHDOG_S
    plus a few seconds (it does not wait at exit for the wedged thread),
    and the stream's spill file is removed."""
    import subprocess
    import sys

    from conftest import REPO

    spill = tmp_path / "spill"
    spill.mkdir()
    (tmp_path / "out").mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, FASIM_WATCHDOG_S="2",
               FASIM_SPILL_DIR=str(spill), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-c", WEDGED_CLI, "-f1",
         os.path.join(ORACLE, "testDNA.fa"), "-f2",
         os.path.join(ORACLE, "H19.fa"), "-O", str(tmp_path / "out"),
         "--tpu-engine", "torch", "--tpu-stream", "on"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _, err = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("the CLI hung after the watchdog") from None
    t_exit = time.monotonic()
    assert proc.returncode == 1, err[-2000:]
    assert "WatchdogError: scan watchdog: a device batch" in err, err[-2000:]
    t0 = float(err.split("T0 ", 1)[1].split()[0])
    assert 2 <= t_exit - t0 < 2 + 10, t_exit - t0
    assert os.listdir(spill) == []


MIB32 = 32 * 1024 * 1024


def test_wants_stream_threshold(tmp_path):
    """`auto` streams a DNA file larger than 32 MiB (fasim_tpu/cli.py:
    188-191): one byte past it, not at exactly 32 MiB; `on` and `off`
    override the size."""
    at, past = tmp_path / "at.fa", tmp_path / "past.fa"
    for path, size in ((at, MIB32), (past, MIB32 + 1)):
        path.touch()
        os.truncate(path, size)  # sparse: no 32 MiB written
    auto, on, off = (TpuConfig(stream=s) for s in ("auto", "on", "off"))
    assert cli.wants_stream(auto, str(past))
    assert not cli.wants_stream(auto, str(at))
    assert cli.wants_stream(on, str(at))
    assert not cli.wants_stream(off, str(past))
    assert TpuConfig().stream == "auto"


@pytest.mark.parametrize("stream,size,driver", [
    ("on", 0, "stream"), ("off", MIB32 + 1, "batched"),
    ("auto", MIB32 + 1, "stream"), ("auto", MIB32, "batched")])
def test_cli_picks_driver(tmp_path, monkeypatch, stream, size, driver):
    """`main` runs the driver `wants_stream` picks, on cuda:0.  The engine
    and the drivers are stand-ins: nothing is scanned."""
    from fasim_tpu_torch.kernels import engine as engine_mod

    dna = tmp_path / "dna.fa"
    dna.touch()
    os.truncate(dna, size)
    made, driven = [], []

    class Engine:
        def __init__(self, rna, device):
            made.append(device)

    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(engine_mod, "TorchScanEngine", Engine)
    for name in ("batched", "stream"):
        monkeypatch.setattr(batched, f"scan_file_{name}",
                            lambda p, eng, name=name, **kw:
                            driven.append(name))
    monkeypatch.setattr(cli, "run", lambda p, tpu, scan: scan(p, None) or 0)
    assert cli.main(["-f1", str(dna), "-f2", "b.fa", "--tpu-stream",
                     stream]) == 0
    assert made == ["cuda:0"] and driven == [driver]


def test_stream_cli_raises_without_gpu(tmp_path, monkeypatch):
    """`--tpu-stream on` runs on cuda:0 like the batched driver: without
    a GPU it raises instead of falling back to the CPU."""
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-f1", os.path.join(ORACLE, "testDNA.fa"), "-f2",
                  os.path.join(ORACLE, "H19.fa"), "-O", str(tmp_path),
                  "--tpu-stream", "on"])
