"""The port's recorder (`profiling.STAGES`) on the CPU, through `cli.main`
with the torch engine on a small input (a 60-nt query, 300-nt records).

Spans: every span's parent chain reaches its job's `job` span, across
the stage, pool and warm threads; under torch.profiler the record holds
the program's `fasim.*` ranges, pool threads' too, and a span starts
within 1 ms of its range (one clock); with tracing off no span is kept;
FASIM_TRACE writes the job's spans as a Chrome trace.  Counters: every
report() value is a number, seconds but for `wall` and the `n_` counts;
the scan and window cells equal the shapes computed by hand; an input
whose threshold saturates counts its batch, and scans it once.  The
output files and stdout are the same bytes with tracing on and off."""

import contextlib
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from fasim_tpu_torch import cli, rules
from fasim_tpu_torch.config import Params
from fasim_tpu_torch.kernels.engine import TorchScanEngine
from fasim_tpu_torch.kernels.window import K4_SHORT, NARROW, WIDTHS
from fasim_tpu_torch.profiling import STAGES
from fasim_tpu_torch.scan import batched, prewarm

N_RECORDS = 3
RECORD = 300
QUERY = 60
T = len(rules.scan_list(0, 0))  # 48 scans a segment at -r 0 -t 0


def _arrays(hit: int = QUERY):
    """A QUERY-nt query and a RECORD-nt record holding a `hit`-nt stretch
    that the first scan maps onto the query's start (so the hit scores
    about 5 a base): (dna, rna) uint8 arrays."""
    rng = np.random.default_rng(3)
    dna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, RECORD)]
    dna = dna.copy()
    dna[100:100 + QUERY] = np.frombuffer(b"ACG", np.uint8)[
        rng.integers(0, 3, QUERY)]
    sc = rules.scan_list(0, 0)[0]
    rna = rules.transfer_lut(sc["strand"], sc["para"], sc["rule"])[
        dna[100:100 + QUERY]].copy()
    # break the match past `hit` bases: the query's tail is random
    rna[hit:] = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, QUERY - hit)]
    return dna, rna


def _write_inputs(path, hit: int):
    """`_arrays(hit)` as files in `path`, the record N_RECORDS times,
    rotated.  Returns the (dna, rna) file names, relative to `path`: the
    output files' names embed the DNA file's."""
    dna, rna = _arrays(hit)
    with open(path / "dna.fa", "w") as f:
        for i in range(N_RECORDS):
            a = 1000 + 1000 * i
            f.write(f">hg19|chr1|{a}-{a + RECORD - 1}\n"
                    f"{np.roll(dna, 7 * i).tobytes().decode()}\n")
    with open(path / "rna.fa", "w") as f:
        f.write(f">Q\n{rna.tobytes().decode()}\n")
    return "dna.fa", "rna.fa"


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    monkeypatch.delenv("FASIM_TRACE", raising=False)
    monkeypatch.delenv("FASIM_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    return _write_inputs(tmp_path, QUERY)


def _run(dna, rna, out, extra=()):
    """cli.main on the torch engine, one segment a batch; its stdout."""
    os.makedirs(out, exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["-f1", str(dna), "-f2", str(rna), "-O", str(out),
                         "--tpu-engine", "torch",
                         "--tpu-segments-per-batch", "1",
                         "--tpu-stdout-compat", "true", *extra]) == 0
    return [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("Running time is")]


def _chains(spans):
    """Each span's names up its parents, and whether it ends at a `job`
    span of its own job id."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        chain = [s]
        while chain[-1].parent:
            chain.append(by_id[chain[-1].parent])
        out.append((s, chain))
    return out


@pytest.mark.parametrize("extra", [[], ["-F"], ["--tpu-stream", "on"]],
                         ids=["fastsim", "sim", "stream"])
def test_every_span_reaches_its_job(inputs, tmp_path, monkeypatch, extra):
    trace = tmp_path / "trace.json"
    monkeypatch.setenv("FASIM_TRACE", str(trace))
    monkeypatch.setenv("FASIM_SPILL_DIR", str(tmp_path))
    STAGES.start_run()
    _run(*inputs, tmp_path / "out", extra)
    spans = STAGES.spans()
    [job] = [s for s in spans if s.name == "job"]
    for s, chain in _chains(spans):
        assert chain[-1] is job, [c.name for c in chain]
        assert s.job == job.job and s.start_ns <= s.end_ns
        assert job.start_ns <= s.start_ns and s.end_ns <= job.end_ns
    busy = "host_candidate_busy" if "-F" in extra else "cand_finalize_busy"
    names = {s.name for s in spans}
    assert {"engine_setup", "batch", "device_wait", "output",
            "cluster_triplex", "write_tfosorted", "bedgraphs",
            busy} <= names
    # the batch spans run on the stage threads, the finalize on the pool:
    # each below its batch, with the batch's index and its segment
    batches = {s.id: s for s in spans if s.name == "batch"}
    assert sorted(s.batch for s in batches.values()) == list(
        range(N_RECORDS))
    for s in spans:
        if s.name == busy:
            assert s.parent in batches and s.segment == 0
            assert s.batch == batches[s.parent].batch
            assert s.thread != job.thread
    assert all(batches[s.parent].thread != job.thread
               for s in spans if s.name == "device_wait")
    # the Chrome trace of the job: one complete event a span
    events = json.loads(trace.read_text())["traceEvents"]
    done = [e for e in events if e["ph"] == "X"]
    assert sorted(e["args"]["id"] for e in done) == sorted(
        s.id for s in spans)


def test_warm_thread_spans_reach_the_job(inputs, monkeypatch):
    """prewarm's threads (on an engine that reports a card) open their
    span below the span current where the driver started them."""
    monkeypatch.setenv("FASIM_TRACE", os.devnull)
    monkeypatch.setattr(prewarm, "_kernel_library", lambda: None)
    monkeypatch.setattr(prewarm, "_on_device",
                        lambda device: contextlib.nullcontext())
    rna, recs = _small()
    STAGES.start_run()
    with STAGES.job():
        batched.scan_records(Params(), recs, rna, FakeCuda(rna),
                             batch_pairs=1)
    spans = STAGES.spans()
    warm = [s for s, chain in _chains(spans) if s.name == "prewarm"
            and chain[-1].name == "job"]
    assert len(warm) == 2  # the native library's, the engine's
    assert all(s.thread != threading.get_native_id() for s in warm)


def test_profiler_ranges_share_the_clock(inputs, tmp_path):
    """Under torch.profiler (host activity; every thread) the record holds
    the job, batch and pool-thread finalize ranges, and each span starts
    within 1 ms of its range's start."""
    from torch._C._profiler import _ExperimentalConfig

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        STAGES.start_run()
        assert STAGES.tracing
        _run(*inputs, tmp_path / "out")
    finally:
        prof.stop()
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("fasim."):
            ranges.setdefault(e.name()[6:], []).append(
                (e.start_ns(), e.start_thread_id()))
    spans = STAGES.spans()
    job = next(s for s in spans if s.name == "job")
    assert {"job", "batch", "cand_finalize_busy"} <= set(ranges)
    tids = {tid for _, tid in ranges["cand_finalize_busy"]}
    assert tids.isdisjoint({tid for _, tid in ranges["job"]})
    for name in ("job", "batch", "cand_finalize_busy", "output"):
        starts = sorted(a for a, _ in ranges[name])
        mine = sorted(s.start_ns for s in spans if s.name == name)
        assert len(starts) == len(mine), name
        for a, b in zip(starts, mine):
            assert abs(a - b) < 1_000_000, (name, (b - a) / 1e6)
    # the profiler stopped: the next job keeps no span
    _run(*inputs, tmp_path / "again")
    assert len(STAGES.spans()) == len(spans)


def test_tracing_off_keeps_no_spans(inputs, tmp_path):
    STAGES.start_run()
    assert not STAGES.tracing
    _run(*inputs, tmp_path / "out")
    assert STAGES.spans() == []
    assert STAGES.current() is None
    assert STAGES.report()["n_job"] == 1


def test_report_is_numbers_and_seconds(inputs, tmp_path):
    STAGES.start_run()
    _run(*inputs, tmp_path / "out")
    rep = STAGES.report()
    assert rep["n_batches"] == N_RECORDS
    for key, value in rep.items():
        assert isinstance(value, (int, float)) and not isinstance(
            value, bool), key
        if key.startswith("n_"):
            assert isinstance(value, int) and value >= 0, key
        else:
            # seconds (the harness prints them as shares of its window;
            # a stage of several threads sums them)
            assert isinstance(value, float) and value >= 0, key
    assert rep["job"] <= rep["wall"]


def test_cells_equal_the_shapes(inputs, tmp_path, monkeypatch):
    """n_scan_cells: S x T x m16 x n_pad a pass (one pass: the query and
    the segments are pure ACGT, so the threshold comes from the ssw pass;
    a saturated batch is not scanned again); n_window_cells: each
    dispatched window's rlen x (max(mreal, m) - off), from the dispatches'
    specs."""
    specs = []
    real = TorchScanEngine.window_pass_specs

    def keep(self, segs, lengths, spec, rev):
        specs.append({k: np.asarray(v) for k, v in spec.items()})
        return real(self, segs, lengths, spec, rev)

    monkeypatch.setattr(TorchScanEngine, "window_pass_specs", keep)
    STAGES.start_run()
    _run(*inputs, tmp_path / "out")
    rep = STAGES.report()
    m16 = (QUERY + 15) // 16 * 16
    n_pad = (RECORD + 127) // 128 * 128
    passes = rep["n_batches"]
    assert rep["n_scan_cells"] == passes * 1 * T * m16 * n_pad
    want = sum(int((s["rlens"] * (np.maximum(s["mreals"], QUERY)
                                  - s["offs"])).sum()) for s in specs)
    assert rep["n_window_cells"] == want > 0
    rows = [len(s["rlens"]) for s in specs]
    assert rep["n_window_rows_fwd0"] + rep.get("n_window_rows_fwd1", 0) \
        + rep["n_window_rows_rev"] == sum(rows)
    assert rep["n_peaks"] == rep["n_window_rows_fwd0"]
    assert rep["n_winners"] >= rep["n_window_rows_rev"]
    assert "n_scan_cells_prewarm" not in rep  # no card, no warm


@pytest.mark.parametrize("hit,saturated", [(QUERY, N_RECORDS), (30, 0)])
def test_escalation_is_counted(tmp_path, monkeypatch, hit, saturated):
    """A 60-base hit scores >= 251 (the batch saturates); a 30-base one
    does not.  Neither batch is scanned again: one scan pass a batch, and
    no call asks for a full-prefix rerun."""
    monkeypatch.chdir(tmp_path)
    dna, rna = _write_inputs(tmp_path, hit)
    full_prefix = []
    real = TorchScanEngine.scan_segments

    def scan(self, *args, **kw):
        full_prefix.append(bool(kw.get("full_prefix")))
        return real(self, *args, **kw)

    monkeypatch.setattr(TorchScanEngine, "scan_segments", scan)
    STAGES.start_run()
    _run(dna, rna, tmp_path / "out")
    rep = STAGES.report()
    assert rep.get("n_batches_saturated", 0) == saturated
    assert "n_batches_escalated" not in rep and "n_escalation" not in rep
    assert full_prefix == [False] * rep["n_batches"]
    m16 = (QUERY + 15) // 16 * 16
    n_pad = (RECORD + 127) // 128 * 128
    assert rep["n_scan_cells"] == rep["n_batches"] * T * m16 * n_pad


def test_prewarm_cells_are_counted_apart(monkeypatch):
    """A warm thread's scan and window cells go to the `_prewarm`
    counters: one zero segment n_pad wide, and one window of each warm
    width forward and reverse."""
    monkeypatch.delenv("FASIM_PREWARM", raising=False)
    monkeypatch.setattr(prewarm, "_kernel_library", lambda: None)
    monkeypatch.setattr(prewarm, "_on_device",
                        lambda device: contextlib.nullcontext())
    rna, recs = _small(5)
    STAGES.start_run()
    batched.scan_records(Params(), recs, rna, FakeCuda(rna), batch_pairs=1)
    rep = STAGES.report()
    m16 = (QUERY + 15) // 16 * 16
    n_pad = (RECORD + 127) // 128 * 128
    assert rep["n_scan_cells_prewarm"] == T * m16 * n_pad
    rlens = sorted({NARROW, *WIDTHS, *K4_SHORT.values()})
    assert rep["n_window_cells_prewarm"] == 2 * sum(rlens) * m16
    assert rep["n_scan_cells"] == rep["n_batches"] * T * m16 * n_pad


def test_outputs_identical_with_tracing_on(inputs, tmp_path, monkeypatch):
    STAGES.start_run()
    plain = _run(*inputs, tmp_path / "off")
    monkeypatch.setenv("FASIM_TRACE", str(tmp_path / "trace.json"))
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        STAGES.start_run()
        assert STAGES.tracing
        traced = _run(*inputs, tmp_path / "on")
    finally:
        prof.stop()
    assert traced == plain
    names = sorted(os.listdir(tmp_path / "off"))
    assert names == sorted(os.listdir(tmp_path / "on")) and names
    for name in names:
        assert (tmp_path / "off" / name).read_bytes() == (
            tmp_path / "on" / name).read_bytes(), name
    # the default profiler records the main thread's ranges
    ranges = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"fasim.job", "fasim.output", "fasim.host_candidate_wait"} \
        <= ranges


def _small(n_records: int = N_RECORDS):
    """`_arrays()` as the query and the records the driver takes."""
    dna, rna = _arrays()
    return rna, [type("R", (), {"seq": np.roll(dna, 7 * i)})()
                 for i in range(n_records)]


class FakeCuda:
    """A CPU engine that reports cuda:0, so that the driver warms it."""

    def __init__(self, rna):
        self.inner = TorchScanEngine(rna, device="cpu")
        self.device = torch.device("cuda:0")
        self.warmed = set()
        self.warm_jobs = []

    def __getattr__(self, name):
        return getattr(self.inner, name)
