"""Run one cell of the benchmark once: `python3 portbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>` from the root of
a checkout on a machine with an NVIDIA GPU.  The last line of standard
output is the result's JSON object; the numbers the correctness check
compared end standard error.  See portbench/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the program's kernel caches at fixed paths inside the checkout (its own
# build/ holds the nvcc and g++ builds)
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
# transformers and similar libraries load JAX on their own unless told not
# to; nothing the benchmark runs may hold it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def visible_cards(environ=os.environ) -> list[str] | None:
    """The cards a CUDA program started now would see, as
    CUDA_VISIBLE_DEVICES names them (its entries up to the first empty
    one), or every card NVML counts where it is unset; None where
    neither says.  Reads no CUDA state, so CUDA can still be pinned."""
    if "CUDA_VISIBLE_DEVICES" in environ:
        names = []
        for name in environ["CUDA_VISIBLE_DEVICES"].split(","):
            if not name.strip():
                break
            names.append(name.strip())
        return names
    import ctypes

    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        n = ctypes.c_uint(0)
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(n)) != 0:
            return None
        return [str(i) for i in range(n.value)]
    finally:
        nvml.nvmlShutdown()


def pin_cards(chips: int, environ=os.environ) -> str:
    """Keep the first `chips` visible cards where more are visible, by
    CUDA_VISIBLE_DEVICES, before CUDA starts: the cell gets the cards it
    asks for, and the program, which by default builds an engine for
    every card it sees, no more.  Returns a line for standard error."""
    names = visible_cards(environ)
    if names is None:
        return (f"cards: the cell asks for {chips}; visible not read (no "
                "CUDA_VISIBLE_DEVICES, no NVML), none pinned")
    if len(names) > chips:
        environ["CUDA_VISIBLE_DEVICES"] = ",".join(names[:chips])
        return (f"cards: {len(names)} visible, {chips} kept "
                f"(CUDA_VISIBLE_DEVICES={environ['CUDA_VISIBLE_DEVICES']})")
    return f"cards: {len(names)} visible, {len(names)} kept"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    from portbench import harness

    bench = harness.manifest()
    spec = harness.load_cell(args.workload, bench)
    chips = spec[0]["chips"]
    # torch is imported by now; CUDA starts at its first use, below
    print(pin_cards(chips), file=sys.stderr)

    import fasim_tpu_torch  # noqa: F401  (the program under test)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} GPUs; this machine shows "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), T_START, bench=bench,
                                     cell_spec=spec)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
