"""Build and load the hand-written CUDA kernels of `csrc/`.

`nvcc` compiles every `csrc/*.cu` for Hopper (sm_90a), one process per
source, all started together, and links the objects into one shared
library with a plain C interface, `build/kernels/libfasim_cuda.so` beside
the package, at first use; the library is loaded with ctypes.  A rebuild
happens when the sources' hash changes.  Nothing here runs at import, so
the CPU tests (no nvcc, no card) import the kernel modules freely.

Calling convention (every entry point): tensor pointers as `c_void_p`
from `data_ptr()`, the launch stream as `c_void_p` from
`torch.cuda.current_stream().cuda_stream`, ints as `c_int`; the entry
returns `cudaGetLastError()` after its launch and `check` raises on a
non-zero code.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..profiling import STAGES

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
LIB_NAME = "libfasim_cuda.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (restype is c_int for all but the error string)
SIGNATURES = {
    "fasim_scan_colmax": [_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P,
                          _P, _P, _P],
    "fasim_scan_blocks_per_sm": [_I, _I],
    "fasim_scan_colmax16": [_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I,
                            _P, _P, _P, _P],
    "fasim_scan16_blocks_per_sm": [_I, _I],
    "fasim_scan_strip_rows": [],
    "fasim_scan_rows": [_I],
    "fasim_scan_codes_colmax": [_P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                                _P],
    "fasim_scan_codes_plan": [_I, _I, _P],
    "fasim_scan_codes_scratch": [_I, _I, _I],
    "fasim_scan_codes_blocks_per_sm": [_I, _I, _I],
    "fasim_window_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "fasim_window_gen": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _P, _P],
    "fasim_window_v1": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _P, _P],
    "fasim_sim_forward": [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "fasim_sim_forward_smem": [_I],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME or CUDA's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/*.cu unless the library for their hash exists; returns
    the library path.  The compiler's output (ptxas register and spill
    report) is kept in build/kernels/build.log."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = _digest(sources)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    with STAGES.timer("build"):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"tmp{os.getpid()}"
        cus = [s for s in sources if s.suffix == ".cu"]
        objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cus, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
        link = None
        if all(proc.returncode == 0 for proc in procs):
            link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            logs.append(link.stdout + link.stderr)
        (BUILD_DIR / "build.log").write_text("".join(logs))
        for o in objs:
            o.unlink(missing_ok=True)
        if link is None or link.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + "".join(logs)[-4000:])
        os.replace(tmp, lib)  # atomic against a concurrent build
        stamp.write_text(digest)
        return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.fasim_cuda_error_string.argtypes = [ctypes.c_int]
            handle.fasim_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, entry: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        msg = lib().fasim_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")


_count_lock = threading.Lock()
_counting = threading.local()


def counted_apart() -> bool:
    """Whether this thread runs inside `launches_to`: its work (launches,
    scan and window cells) is counted apart from the main path's."""
    return getattr(_counting, "target", None) is not None


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches` count (scan/batched.py launches
    window passes from several stage threads), or, on a thread inside
    `launches_to(target)`, to `target.launches` instead."""
    target = getattr(_counting, "target", None) or wrapper
    with _count_lock:
        target.launches += 1


@contextlib.contextmanager
def launches_to(target):
    """Count this thread's launches in `target.launches`, not in the
    wrappers' counts (scan/prewarm.py's warm launches)."""
    _counting.target = target
    try:
        yield
    finally:
        _counting.target = None


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on the tensor's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
