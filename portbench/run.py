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
