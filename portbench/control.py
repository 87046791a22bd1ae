"""The correctness check's control: the reference put in the program's
place with identity and stability in bfloat16, the precision below the
float32 the configuration states, judged by the check's comparison.

For each seed it draws the cell's jobs and its sample of (job, record)
pairs as a run of the cell does, with `--jobs` jobs taken as the
window's, computes the sampled records' triplexes in float32 (the
reference) and in bfloat16 (the control) and prints the check's
`record_rows_diff` of the control.  The control's output stage would be
the reference's own writers, so its `output_lines_diff` is 0 by
construction; the control has to fail `record_rows_diff`.

    python3 portbench/control.py --workload neat1_peaks.peaks64 \
        --jobs 14 --seeds 11 12 13

Runs on the card when it has one, else on the CPU (slow at cell size).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, harness, traffic  # noqa: E402
from portbench.reference import fasta as rfasta  # noqa: E402
from portbench.reference import fastsim  # noqa: E402


def control_rows_diff(cell_spec, seed: int, n_jobs: int, device) -> dict:
    """The control's record_rows_diff on the sample a run of `n_jobs`
    jobs would check, with the sample's size."""
    cell, config, mix = cell_spec
    work = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        runner = harness.Runner(config, mix, seed, work, [])
        jobs = [runner.write(next(runner.window_specs))
                for _ in range(n_jobs)]
        pairs = traffic.sample([j.spec for j in jobs], mix["check_records"],
                               traffic.rng(seed, traffic.SAMPLE))
        p = harness.params_of(config)
        _, rna = rfasta.read_rna(runner.lnc)
        ref = check.reference_rows(p, work, rna, jobs, pairs, device)
        ctl = check.reference_rows(p, work, rna, jobs, pairs, device,
                                   rnd=fastsim.bfloat16)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    diff = sum(check.rows_diff(ctl[pair], ref[pair]) for pair in pairs)
    rows = sum(len(ref[pair]) for pair in pairs)
    return {"record_rows_diff": diff, "reference_rows": rows,
            "records": len(pairs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--jobs", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    spec = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_rows_diff(spec, seed, args.jobs, device)
        out.update(workload=args.workload, seed=seed, device=device,
                   seconds=time.perf_counter() - t0,
                   limit=check.LIMITS["record_rows_diff"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
