"""Warm-up of a fresh process's one-time costs on the card (counterpart of
fasim_tpu/scan/prewarm.py).

The JAX package starts the compile of every static kernel shape on
threads right after engine setup, so that a one-shot CLI run does not
discover and compile them one at a time.  The port compiles nothing per
shape: batches are trimmed, not padded (kernels/engine.py), and the
kernels build once per checkout.  What a fresh port process still pays
before its first result is:

  * the nvcc build of build/kernels/libfasim_cuda.so and the g++ build of
    the native library, where the checkout has none, and loading both;
  * CUDA's lazy load of each kernel's module at its first launch, and the
    first calls of the torch ops around the kernels.

`prewarm_engines`, which the drivers' `iter_scan_work` calls after the
engines' setup (FASIM_PREWARM=1, the default; 0 turns it off), starts the
two library builds on threads of their own, so that nvcc and g++ run side
by side, and on each CUDA engine's device one scan of a zero segment and,
unless `windows` is false, a forward and a reverse window pass over one
row of every width class.  Both go through the engine's own methods, so
they launch exactly the kernels its switches route to: K1, K7 (under
FASIM_SCAN16=1) or K5 (use_v2=False) for the scan; K3 and K4, K4 alone
(FASIM_WIN_V3=0) or K6 (FASIM_WIN_V1=1) for the windows.  CPU engines are
skipped, as the JAX package skips XLA on the CPU.  Each engine is warmed
once per (n_pad, batch_pairs); the record of it lives on the engine.

Differences from fasim_tpu's:

  * a warm job's failure is not swallowed: it is kept in the engine's
    `warm_jobs`, which the driver joins (`pending`) before its first
    dispatch to that engine, and raised there;
  * the warm launches are counted in `prewarm_engines.launches`, never in
    a kernel wrapper's `launches` (`_build.launches_to`), and its scan and
    window cells in `STAGES`' `scan_cells_prewarm` and
    `window_cells_prewarm`, not in `scan_cells` and `window_cells`;
  * the scan warm is one segment of n_pad columns, not a full batch: the
    kernels do not compile per shape.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import Future

import numpy as np
import torch

from .. import native
from ..kernels import _build
from ..kernels.window import K4_SHORT, NARROW, WIDTHS
from ..profiling import STAGES

# the warm threads' name
THREAD_NAME = "fasim-prewarm"
# one window of each width K3, K4 and K6 launch apart: the width classes
# and their short forms
WARM_RLENS = np.array(sorted({NARROW, *WIDTHS, *K4_SHORT.values()}),
                      np.int32)


def prewarm_engines(engines, n_pad: int, batch_pairs: int,
                    windows: bool) -> None:
    """Start the warm jobs of every CUDA engine not yet warmed for
    (n_pad, batch_pairs); each engine's `warm_jobs` gets their futures."""
    todo = []
    for eng in engines:
        if eng.device.type != "cuda":
            continue  # the plain versions have nothing to load
        key = (n_pad, batch_pairs)
        if key in eng.warmed:
            continue
        eng.warmed.add(key)
        todo.append(eng)
    if not todo:
        return
    libs = _start(native._load)
    for eng in todo:
        jobs = [lambda eng=eng: _scan_job(eng, n_pad)]
        if windows:
            jobs.append(lambda eng=eng: _window_job(eng, n_pad))
        eng.warm_jobs += [libs, _start(_warm, eng.device, jobs)]


prewarm_engines.launches = 0


def pending(eng) -> list[Future]:
    """Take the engine's outstanding warm jobs; the caller reads each
    result, which raises the job's failure."""
    jobs, eng.warm_jobs = eng.warm_jobs, []
    return jobs


def _start(fn, *args) -> Future:
    """Run fn(*args) on a daemon thread, inside the span `prewarm` whose
    parent is the caller's current span; its future holds the outcome."""
    fut: Future = Future()
    job = STAGES.spanned("prewarm", fn)

    def run():
        try:
            fut.set_result(job(*args))
        except BaseException as exc:  # kept for the driver to raise
            fut.set_exception(exc)

    threading.Thread(target=run, daemon=True, name=THREAD_NAME).start()
    return fut


def _kernel_library() -> None:
    _build.lib()


def _warm(device, jobs) -> None:
    """Build and load the kernel library, then run the jobs on `device`,
    their launches counted apart."""
    _kernel_library()
    with _on_device(device), _build.launches_to(prewarm_engines):
        for job in jobs:
            job()


@contextlib.contextmanager
def _on_device(device):
    """The block with `device` current on this thread (the CUDA device is
    per thread), then a wait for its work on this thread's stream, so a
    failed launch raises here.  The warm tensors are used only on that
    stream, so they are freed safely."""
    with torch.cuda.device(device):
        yield
        torch.cuda.current_stream(device).synchronize()


def _scan_job(eng, n_pad: int) -> None:
    """One zero segment n_pad columns wide through the batch dispatch: the
    scan kernel of the engine's route (the int16 gate reads the width)
    and the candidate packing."""
    eng.scan_segments_packed(np.zeros((1, n_pad), np.uint8),
                             np.full(1, min(n_pad, 128), np.int32))


def _window_job(eng, n_pad: int) -> None:
    """One window of each width in WARM_RLENS, forward as the main path's
    uniform specs (K3's) and reverse (K4's), through the engine's
    routing."""
    k = len(WARM_RLENS)
    zeros = np.zeros(k, np.int32)
    spec = {"seg_idx": zeros, "scan_idx": zeros, "base": zeros,
            "dirn": np.ones(k, np.int32), "rlens": WARM_RLENS,
            "offs": zeros, "terms": np.full(k, -1, np.int32),
            "mreals": np.full(k, eng.m16, np.int32)}
    segs = np.zeros((1, n_pad), np.uint8)
    lengths = np.full(1, n_pad, np.int32)
    for rev in (False, True):
        eng.window_pass_specs(segs, lengths, spec, rev=rev)
