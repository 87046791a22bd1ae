"""The port's multi-device paths on the CPU, held exactly against one
engine and against the JAX package:

  * the batched and the streaming driver round-robin their batches over
    2 and 3 CPU engines (one batch a segment, so there are more batches
    than engines where the input allows): the hits astuple-identical to
    one engine's and to the JAX package's `scan_file_batched` over a list
    of XlaScanEngines (on its virtual CPU devices), on meg3_sub3 and on
    the planted-homology input of the dry run; the streamed store's
    columns equal one engine's; engine i dispatches batches i, i + n, ...;
    `-F` under FASIM_SIM_DEVICE=1 on h19F_trunc's inputs (cut into 4
    segments of 400 nt, so that more than one engine gets a batch), with
    each engine's forward scans on its own device;
  * `dist.sharded_scan_step` on (8, 1), (2, 4) and (1, 8) meshes of CPU
    devices equals the JAX package's on the same mesh shapes, and
    `dist.byte_break` the JAX package's;
  * the runner's `check_shard_coverage` messages, `_allgather_bytes` at
    world size 1, its checkpoint spills (only the port's own payloads are
    loaded) and a resumed `scan_distributed` that scans nothing again;
  * `dryrun_multichip` on 4 CPU devices.

Each engine of a run is a memoizing engine of tests/test_torch_stream.py
(one per slot, shared by the module), so a (batch, engine) call is
computed once; the drivers' own code runs in full every time."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from conftest import ORACLE

import jax
from fasim_tpu import dist as jax_dist
from fasim_tpu.config import Params as JaxParams
from fasim_tpu.dist import runner as jax_runner
from fasim_tpu.kernels.xla import XlaScanEngine
from fasim_tpu.scan import batched as jax_batched
from fasim_tpu.scan.pipeline import Triplex as JaxTriplex

from fasim_tpu_torch import dist, rules
from fasim_tpu_torch.config import Params
from fasim_tpu_torch.dist import dryrun, runner
from fasim_tpu_torch.io import fasta
from fasim_tpu_torch.kernels.engine import TorchScanEngine
from fasim_tpu_torch.post.output import print_result
from fasim_tpu_torch.scan import batched
from test_torch_stream import MemoEngine

_CACHE: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)  # six xdist workers share the box
    yield
    torch.set_num_threads(prev)


class CountedEngine(MemoEngine):
    """A memoizing CPU engine that counts the batches dispatched to it."""

    def __init__(self, rna):
        super().__init__(TorchScanEngine(rna, device="cpu"))
        self.batches = 0

    def scan_segments_packed(self, *args, **kw):  # fastSIM dispatch
        self.batches += 1
        return self.__getattr__("scan_segments_packed")(*args, **kw)

    def scan_segments(self, *args, **kw):  # -F dispatch, escalation rerun
        if not kw.get("full_prefix"):
            self.batches += 1
        return self.__getattr__("scan_segments")(*args, **kw)


def _engines(case: str, rna, n: int) -> list:
    """The first n of the module's three engines for this case."""
    key = ("engines", case)
    if key not in _CACHE:
        _CACHE[key] = [CountedEngine(rna) for _ in range(3)]
    engines = _CACHE[key][:n]
    for eng in engines:
        eng.batches = 0
    return engines


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    td = tmp_path_factory.mktemp("planted")
    dryrun._planted(str(td))
    return str(td)


def _case(name: str, planted_dir: str):
    """(Params fields, batch count) of a case at one segment a batch."""
    if name == "planted":
        return dict(file1path=f"{planted_dir}/dna.fa",
                    file2path=f"{planted_dir}/rna.fa", c_length=40), 6
    if name == "meg3_sub3":
        return dict(file1path=os.path.join(ORACLE, "meg3sub3.fa"),
                    file2path=os.path.join(ORACLE, "MEG3.fa")), 3
    assert name == "h19F_trunc"
    return dict(file1path=os.path.join(ORACLE, "testDNAt.fa"),
                file2path=os.path.join(ORACLE, "H19t.fa"), c_length=40,
                do_fast_sim=False, cut_length=400, overlap_length=100), 4


def _astuples(hits) -> list:
    return [dataclasses.astuple(t) for t in hits]


def _jax_hits(case: str, fields: dict) -> list:
    """The JAX package's scan_file_batched over three XlaScanEngines, one
    a virtual CPU device, one segment a batch."""
    key = ("jax", case)
    if key not in _CACHE:
        p = JaxParams(**fields)
        _, rna = fasta.read_rna(p.file2path)
        engines = [XlaScanEngine(rna, device=d) for d in jax.devices()[:3]]
        _, _, _, hits = jax_batched.scan_file_batched(p, engines,
                                                      batch_pairs=1,
                                                      host_threads=2)
        _CACHE[key] = _astuples(hits)
    return _CACHE[key]


def _port_run(case: str, fields: dict, n: int, driver: str, tmp_path):
    """The port's driver on n engines: (astuples of the hits, the frozen
    store columns or None, the output files), the dispatches checked."""
    p = Params(**fields)
    _, rna = fasta.read_rna(p.file2path)
    engines = _engines(case, rna, n)
    if driver == "batched":
        recs, lnc, _, hits = batched.scan_file_batched(
            p, engines, batch_pairs=1, host_threads=2)
        first, size, cols = recs[0], len(recs[0].seq), None
        rows = _astuples(hits)
    else:
        recs, lnc, _, hits = batched.scan_file_stream(
            p, engines, batch_pairs=1, host_threads=2,
            spill_dir=str(tmp_path / "spill"))
        first, size = recs[0], recs[0].seq_len
        cols = {k: v.copy() for k, v in hits.cols.items()}
        rows = None
    out = tmp_path / f"out_{driver}_{n}"
    out.mkdir()
    # output names embed the -f1 path
    print_result(dataclasses.replace(
        p, file1path=os.path.basename(p.file1path), outpath=str(out)),
        first.species, lnc, hits, first.chro_tag, size, first.start_genome)
    files = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
    return rows, cols, files, [e.batches for e in engines]


@pytest.fixture
def _sim_device_memo(monkeypatch):
    """FASIM_SIM_DEVICE=1 with each distinct forward scan computed once;
    the devices each call was given are recorded."""
    monkeypatch.setenv("FASIM_SIM_DEVICE", "1")
    devices = []
    cells_fn = batched.sim_forward_cells

    def memo(rna, refs, mins, device):
        devices.append(str(device))
        key = ("cells", rna.tobytes(), tuple(r.tobytes() for r in refs),
               tuple(mins))
        if key not in _CACHE:
            _CACHE[key] = cells_fn(rna, refs, mins, device)
        return [c.copy() for c in _CACHE[key]]

    monkeypatch.setattr(batched, "sim_forward_cells", memo)
    return devices


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("driver", ["batched", "stream"])
@pytest.mark.parametrize("case", ["planted", "meg3_sub3"])
def test_round_robin_matches_one_engine_and_jax(tmp_path, planted, case,
                                                driver, n, monkeypatch):
    monkeypatch.setenv("FASIM_PREWARM", "0")  # the JAX engines' compiles
    fields, nbatch = _case(case, planted)
    rows, cols, files, per_engine = _port_run(case, fields, n, driver,
                                              tmp_path)
    assert per_engine == [len(range(i, nbatch, n)) for i in range(n)]
    one_rows, one_cols, one_files, one = _port_run(
        case, fields, 1, driver, tmp_path)
    assert one == [nbatch]
    assert files == one_files and len(files) == 3
    if driver == "batched":
        assert rows == one_rows and rows
        assert rows == _jax_hits(case, fields)
    else:
        assert sorted(cols) == sorted(one_cols)
        for k, v in one_cols.items():
            assert np.array_equal(cols[k], v), k
        b_rows, _, b_files, _ = _port_run(case, fields, 1, "batched",
                                          tmp_path)
        assert files == b_files
        assert len(cols["genomestart"]) == len(_jax_hits(case, fields))


@pytest.mark.parametrize("n", [2, 3])
def test_round_robin_sim_device(tmp_path, planted, n, monkeypatch,
                                _sim_device_memo):
    """-F under FASIM_SIM_DEVICE=1: the forward scans of a batch run on its
    engine's device (here every engine's is the CPU), its pairs replay on
    the host; the hits equal one engine's and the JAX package's."""
    monkeypatch.setenv("FASIM_PREWARM", "0")
    fields, nbatch = _case("h19F_trunc", planted)
    rows, _, files, per_engine = _port_run("h19F_trunc", fields, n,
                                           "batched", tmp_path)
    assert per_engine == [len(range(i, nbatch, n)) for i in range(n)]
    assert _sim_device_memo and set(_sim_device_memo) == {"cpu"}
    one_rows, _, one_files, _ = _port_run("h19F_trunc", fields, 1,
                                          "batched", tmp_path)
    assert rows == one_rows and rows and files == one_files
    assert rows == _jax_hits("h19F_trunc", fields)


BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def codes_batch():
    """tests/test_dist.py's batch: 8 segments x 48 transforms x 192."""
    rng = np.random.default_rng(5)
    rna = BASES[rng.integers(0, 4, 96)]
    scans = rules.scan_list(0, 0)
    s, n = 8, 192
    codes_t = np.empty((s, len(scans), n), np.int32)
    codes_s = np.empty((s, len(scans), n), np.int32)
    for i in range(s):
        seg = BASES[rng.integers(0, 4, n)]
        s2l = np.stack([rules.make_scan_strings(seg, sc)[0] for sc in scans])
        codes_t[i] = rules.THRESH_ENC[s2l]
        codes_s[i] = rules.SSW_ENC[s2l]
    return rna, codes_t, codes_s


@pytest.mark.parametrize("shape", [(8, 1), (2, 4), (1, 8)])
def test_sharded_scan_step_matches_jax(codes_batch, shape):
    rna, codes_t, codes_s = codes_batch
    eng = XlaScanEngine(rna)
    want_t, want_c = jax_dist.sharded_scan_step(
        jax_dist.make_mesh(*shape), eng.m16)(codes_t, codes_s,
                                             eng.matq_thresh, eng.matq_ssw)
    mesh = dist.make_mesh(*shape, devices=["cpu"] * 8)
    assert mesh.shape == shape and set(mesh.flat) == {torch.device("cpu")}
    thresh, colmax = dist.sharded_scan_step(mesh, rna)(codes_t, codes_s)
    assert thresh.dtype == colmax.dtype == torch.int32
    np.testing.assert_array_equal(thresh.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(colmax.numpy(), np.asarray(want_c))


def test_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        dist.make_mesh(2, 2, devices=["cpu"] * 2)
    assert dist.make_mesh(0, 2, devices=["cpu"] * 5).shape == (2, 2)


def test_byte_break_matches_jax():
    rng = np.random.default_rng(7)
    cm = rng.integers(0, 300, (3, 5, 64)).astype(np.int32)
    cm[0] = np.minimum(cm[0], 250)  # rows without a saturated column
    cm[1, 2, 0] = 251  # saturated at the first column
    got = dist.byte_break(torch.from_numpy(cm))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_dist.byte_break(cm)))


@pytest.mark.parametrize("expected,got,nproc", [
    (10, [0, 2, 3, 4, 6, 7, 8, 9], 2),
    (5, [], 1),
    (7, [0, 1, 2, 3], 3),
])
def test_shard_coverage_messages_match_jax(expected, got, nproc):
    runner.check_shard_coverage(expected, range(expected), nproc)
    with pytest.raises(RuntimeError) as want:
        jax_runner.check_shard_coverage(expected, got, nproc)
    with pytest.raises(RuntimeError) as have:
        runner.check_shard_coverage(expected, got, nproc)
    assert str(have.value) == str(want.value)


def test_allgather_bytes_world_size_one():
    assert not torch.distributed.is_initialized()
    assert runner._allgather_bytes(b"\x00abc") == [b"\x00abc"]
    assert runner._allgather_bytes(b"") == [b""]


def _triplex(cls):
    f32 = np.float32
    return cls(stari=1, endi=30, starj=5, endj=34, strand=0, reverse=1,
               rule=2, nt=30, score=f32(61.5), identity=f32(80.0),
               tri_score=f32(1.5), stri_align="ACG", strj_align="TGC")


def test_spills_accept_only_the_ports_payload(tmp_path):
    """A JAX package's spill in the same directory is never read: its
    name is not the port's, and a file under the port's name that holds
    the JAX package's Triplex is refused before that class is loaded."""
    from fasim_tpu_torch.scan.pipeline import Triplex

    mine = {3: (0, [_triplex(Triplex)])}
    with open(tmp_path / "torch-host0-spill000000.pkl", "wb") as f:
        pickle.dump(mine, f)
    with open(tmp_path / "host0-spill000000.pkl", "wb") as f:
        pickle.dump({4: (0, [_triplex(JaxTriplex)])}, f)
    got = runner._load_spills(str(tmp_path), 0)
    assert list(got) == [3]
    assert _astuples(got[3][1]) == _astuples(mine[3][1])
    assert runner._load_spills(str(tmp_path), 1) == {}
    with open(tmp_path / "torch-host1-spill000000.pkl", "wb") as f:
        pickle.dump({4: (0, [_triplex(JaxTriplex)])}, f)
    with pytest.raises(pickle.UnpicklingError, match="fasim_tpu.scan"):
        runner._load_spills(str(tmp_path), 1)
    with pytest.raises(pickle.UnpicklingError, match="posix.system"):
        runner._loads(pickle.dumps(os.system))


def test_scan_distributed_resumes_from_spills(tmp_path, planted):
    """One process (no process group): the spills of a run let a rerun
    scan nothing, and both give the batched driver's hits."""
    p = Params(**_case("planted", planted)[0])
    _, rna = fasta.read_rna(p.file2path)
    _, _, _, want = batched.scan_file_batched(
        p, _engines("planted", rna, 1), batch_pairs=1, host_threads=2)
    engines = _engines("planted", rna, 2)
    ckpt = str(tmp_path / "ckpt")
    metas, _, _, hits = runner.scan_distributed(
        p, lambda r: engines, batch_pairs=1, host_threads=2,
        checkpoint_dir=ckpt, checkpoint_every=4)
    assert [e.batches for e in engines] == [3, 3]
    spills = sorted(os.listdir(ckpt))
    assert spills == ["torch-host0-spill000000.pkl",
                      "torch-host0-spill000001.pkl"]
    assert _astuples(hits) == _astuples(want) and hits
    assert [m.seq_len for m in metas] == [300] * 6
    engines = _engines("planted", rna, 2)
    metas, _, _, again = runner.scan_distributed(
        p, lambda r: engines, batch_pairs=1, host_threads=2,
        checkpoint_dir=ckpt)
    assert [e.batches for e in engines] == [0, 0]
    assert sorted(os.listdir(ckpt)) == spills
    assert _astuples(again) == _astuples(want)


def test_dryrun_multichip_on_four_cpu_devices():
    msg = dryrun.dryrun_multichip(["cpu"] * 4)
    assert msg.startswith("dryrun_multichip OK") and "6 output files" in msg
