"""Command line of the port: `python -m fasim_tpu_torch.cli`.

The flags are fasim_tpu.cli's own (`parse_args`, so all 18 reference
flags keep their atoi quirks), and the output goes through
fasim_tpu.post.output.print_result, so files and stdout are byte-identical
to the JAX package's.  `--tpu-engine` picks the engine:

  * cuda (default; auto means cuda): TorchScanEngine on cuda:0 with the
    hand-written kernels; raises when torch.cuda.is_available() is false;
  * torch: TorchScanEngine on the CPU with the kernels' plain versions;
  * numpy: the per-segment NumPy golden path (fasim_tpu.scan.pipeline).

Not ported yet: `-F`, streaming (--tpu-stream on) and more
than one device.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from fasim_tpu.cli import parse_args
from fasim_tpu.config import TpuConfig


def make_engine(tpu: TpuConfig, rna: np.ndarray):
    """The engine for `--tpu-engine`, or None for the NumPy golden path."""
    from .kernels.engine import TorchScanEngine

    which = tpu.engine
    if which in ("auto", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("--tpu-engine cuda: no CUDA device "
                               "(torch.cuda.is_available() is false); use "
                               "--tpu-engine torch for the CPU")
        return TorchScanEngine(rna, device="cuda:0")
    if which == "torch":
        return TorchScanEngine(rna, device="cpu")
    if which == "numpy":
        return None
    sys.exit(f"unknown engine {which!r} (cuda|torch|numpy)")


def main(argv: list[str] | None = None) -> int:
    from fasim_tpu.io import fasta
    from fasim_tpu.post.output import print_result
    from fasim_tpu.scan.pipeline import scan_file

    from .scan.batched import scan_file_batched

    p, tpu = parse_args(sys.argv[1:] if argv is None else argv)
    if not p.do_fast_sim or tpu.sim_device:
        sys.exit("-F (exact SIM) is not ported to fasim_tpu_torch yet")
    if tpu.stream == "on":
        sys.exit("--tpu-stream on is not ported to fasim_tpu_torch yet")
    print("Searching triplexes using Fasim")
    profile = tpu.profile or os.environ.get("FASIM_PROFILE", "") not in ("",
                                                                         "0")
    if profile:
        from fasim_tpu.profiling import STAGES

        STAGES.start_run()
    t_start = time.process_time()
    _, rna_probe = fasta.read_rna(p.file2path)
    engine = make_engine(tpu, rna_probe)
    if tpu.stdout_compat:
        # the reference interleaves these with the scan; the final stream
        # is identical when printed up front (record/segment order)
        lnc_probe, _ = fasta.read_rna(p.file2path)
        print(lnc_probe)
        for rec in fasta.iter_dna(p.file1path):
            _, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                           p.overlap_length)
            for s in starts:
                print(f"dnaPos = {s}")
    if engine is None:
        records, lnc_name, rna, tlist = scan_file(p)
    else:
        records, lnc_name, rna, tlist = scan_file_batched(
            p, engine, batch_pairs=tpu.segments_per_batch,
            max_inflight=tpu.max_inflight)
    first = records[0]
    print_result(p, first.species, lnc_name, tlist, first.chro_tag,
                 len(first.seq), first.start_genome,
                 stdout_compat=tpu.stdout_compat)
    print("finished normally")
    if tpu.stdout_compat:
        # reference: clock()-based CPU seconds (never byte-compared)
        print(f"Running time is {time.process_time() - t_start:.6g}")
    if profile:
        import json

        from fasim_tpu.profiling import STAGES

        print("FASIM_PROFILE " + json.dumps(STAGES.report()),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
