"""scan/prewarm.py on the CPU, through the batched driver.

A CPU engine, or FASIM_PREWARM=0, starts no warm thread; a small job
skips the window warm; a warm job's failure raises at the engine's first
dispatch; the warm launches are counted apart from the wrappers'; each
engine is warmed once per (n_pad, batch_pairs).  A card's engine is
stood in for by `FakeCuda`: a CPU engine that reports cuda:0 and counts
each of its batch dispatches as a K1 launch, as the card's would; the
kernel library's build and the device scope are stubbed out (no nvcc,
no card here)."""

import contextlib
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from fasim_tpu_torch import rules
from fasim_tpu_torch.config import Params
from fasim_tpu_torch.kernels import WRAPPERS, _build, read_launches
from fasim_tpu_torch.kernels.engine import TorchScanEngine
from fasim_tpu_torch.scan import batched, prewarm


def _inputs(n_records: int = 3):
    """A 60-nt query and n_records 300-nt records holding one strong hit
    each (as tests/test_torch_isolation.py builds them)."""
    rng = np.random.default_rng(3)
    dna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 300)].copy()
    dna[100:160] = np.frombuffer(b"ACG", np.uint8)[rng.integers(0, 3, 60)]
    sc = rules.scan_list(0, 0)[0]
    rna = rules.transfer_lut(sc["strand"], sc["para"], sc["rule"])[
        dna[100:160]]
    recs = [type("R", (), {"seq": np.roll(dna, 7 * i)})()
            for i in range(n_records)]
    return rna, recs


class FakeCuda:
    """A CPU engine that reports cuda:0; its batch dispatches count as K1
    launches (in the warm thread, prewarm's)."""

    def __init__(self, rna):
        self.inner = TorchScanEngine(rna, device="cpu")
        self.device = torch.device("cuda:0")
        self.warmed = set()
        self.warm_jobs = []
        self.dispatches = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def scan_segments_packed(self, *args, **kw):
        if threading.current_thread().name != prewarm.THREAD_NAME:
            self.dispatches += 1
        _build.count_launch(WRAPPERS["scan_colmax"])
        return self.inner.scan_segments_packed(*args, **kw)


@pytest.fixture
def card(monkeypatch):
    """No kernel library to build and no device scope on the CPU."""
    monkeypatch.setattr(prewarm, "_kernel_library", lambda: None)
    monkeypatch.setattr(prewarm, "_on_device",
                        lambda device: contextlib.nullcontext())


def _starts(monkeypatch) -> list:
    """Record prewarm's thread starts, still running them."""
    started = []
    start = prewarm._start

    def counted(fn, *args):
        started.append(fn)
        return start(fn, *args)

    monkeypatch.setattr(prewarm, "_start", counted)
    return started


@pytest.mark.parametrize("engine,flag,threads", [
    ("cpu", None, 0), ("fake", "0", 0), ("fake", "1", 2)])
def test_threads_only_for_a_card_engine(engine, flag, threads, card,
                                        monkeypatch):
    """A CPU engine, or FASIM_PREWARM=0, starts no warm thread; a card's
    engine starts two (the native library, and the engine's: the kernel
    library, then its scan and window jobs)."""
    if flag is None:
        monkeypatch.delenv("FASIM_PREWARM", raising=False)
    else:
        monkeypatch.setenv("FASIM_PREWARM", flag)
    started = _starts(monkeypatch)
    rna, recs = _inputs()
    eng = (TorchScanEngine(rna, device="cpu") if engine == "cpu"
           else FakeCuda(rna))
    hits = batched.scan_records(Params(), recs, rna, eng, batch_pairs=1)
    assert len(started) == threads
    assert eng.warm_jobs == []
    assert all(hits)


@pytest.mark.parametrize("batch_pairs,windows", [(2, False), (1, True)])
def test_small_job_skips_the_window_warm(batch_pairs, windows, card,
                                         monkeypatch):
    """0 <= n_work_hint <= 2 * batch_pairs (3 work items) skips the window
    warm; the scan warm runs either way."""
    monkeypatch.delenv("FASIM_PREWARM", raising=False)
    jobs = []
    for name in ("_scan_job", "_window_job"):
        monkeypatch.setattr(prewarm, name,
                            lambda eng, n_pad, name=name: jobs.append(name))
    rna, recs = _inputs(3)
    batched.scan_records(Params(), recs, rna, FakeCuda(rna),
                         batch_pairs=batch_pairs)
    assert jobs == ["_scan_job"] + ["_window_job"] * windows


def test_warm_failure_raises_at_first_dispatch(card, monkeypatch):
    """The warm job's exception is raised by the driver before the engine
    dispatches anything; nothing falls back."""
    monkeypatch.delenv("FASIM_PREWARM", raising=False)

    def fail():
        raise RuntimeError("kernel library failed to load")

    monkeypatch.setattr(prewarm, "_kernel_library", fail)
    rna, recs = _inputs()
    eng = FakeCuda(rna)
    with pytest.raises(RuntimeError, match="failed to load"):
        batched.scan_records(Params(), recs, rna, eng, batch_pairs=1)
    assert eng.dispatches == 0


@pytest.fixture
def counts():
    """Every count at 0 before the test and after it."""
    for fn in (*WRAPPERS.values(), prewarm.prewarm_engines):
        fn.launches = 0
    yield
    for fn in (*WRAPPERS.values(), prewarm.prewarm_engines):
        fn.launches = 0


def test_warm_launches_are_counted_apart(card, counts, monkeypatch):
    """The wrappers count the driver's launches only, prewarm's own count
    the warm's; the hits are those of a run without prewarm."""
    monkeypatch.delenv("FASIM_PREWARM", raising=False)
    rna, recs = _inputs(3)
    eng = FakeCuda(rna)
    hits = batched.scan_records(Params(), recs, rna, eng, batch_pairs=1)
    assert eng.dispatches == 3
    assert read_launches()["scan_colmax"] == 3
    assert prewarm.prewarm_engines.launches == 1  # the scan warm
    monkeypatch.setenv("FASIM_PREWARM", "0")
    assert batched.scan_records(Params(), recs, rna, FakeCuda(rna),
                                batch_pairs=1) == hits
    assert prewarm.prewarm_engines.launches == 1
    assert read_launches()["scan_colmax"] == 6


def test_launches_to_counts_one_thread_apart(counts):
    """`_build.launches_to` redirects only its own thread's counts, while
    another thread counts the same wrapper."""
    wrapper = WRAPPERS["window_fwd"]

    class Target:
        launches = 0

    def warm():
        with _build.launches_to(Target):
            for _ in range(1000):
                _build.count_launch(wrapper)

    t = threading.Thread(target=warm)
    t.start()
    for _ in range(1000):
        _build.count_launch(wrapper)
    t.join(timeout=60)
    assert not t.is_alive()
    assert (wrapper.launches, Target.launches) == (1000, 1000)


def test_each_engine_warmed_once_per_key(monkeypatch):
    """A second call with the same (n_pad, batch_pairs) starts nothing; a
    new key warms again; CPU engines never."""
    started = []

    def start(fn, *args):
        started.append(fn)
        fut = Future()
        fut.set_result(None)
        return fut

    monkeypatch.setattr(prewarm, "_start", start)
    rna, _ = _inputs()
    a, b = FakeCuda(rna), FakeCuda(rna)
    cpu = TorchScanEngine(rna, device="cpu")
    prewarm.prewarm_engines([a, b, cpu], 384, 64, True)
    assert len(started) == 3  # the native library, then each engine
    prewarm.prewarm_engines([a, b, cpu], 384, 64, True)
    assert len(started) == 3
    prewarm.prewarm_engines([a, cpu], 512, 64, True)
    assert len(started) == 5
    assert a.warmed == {(384, 64), (512, 64)} and b.warmed == {(384, 64)}
    assert cpu.warmed == set() and cpu.warm_jobs == []
    assert len(prewarm.pending(a)) == 4 and prewarm.pending(a) == []
