"""Command line of the port: `python -m fasim_tpu_torch.cli`.

The reference's flag surface (initEnv, Fasim-LongTarget.cpp:269-377):
-f1 -f2 -O -r -c -m -t -d -i -S -ni -na -pc -pt -o -F -ds -lg -C (long
form with single dash, getopt_long_only style) plus the short aliases of
its optstring; numeric flags keep atoi semantics.  `parse_args` is a copy
of fasim_tpu.cli's, and the output goes through the port's
post.output.print_result, so files and stdout are byte-identical to the
JAX package's.  Framework flags keep the JAX package's --tpu- prefix.
`--tpu-engine` picks the engine:

  * cuda (default; auto means cuda): one TorchScanEngine a CUDA device
    this process sees, with the hand-written kernels (`--tpu-dp-devices
    N` > 0: the first N of them; CUDA_VISIBLE_DEVICES splits the cards
    between processes); raises when torch.cuda.is_available() is false;
  * torch: max(1, N) TorchScanEngines on the CPU with the kernels' plain
    versions;
  * numpy: the per-segment path (scan/pipeline.py) with the NumPy golden
    engine (kernels/batch_np.py).

The cuda and torch engines run the batched driver, or the streaming one
(records read one at a time, hits in a columnar store whose alignment
strings spill to FASIM_SPILL_DIR, default TMPDIR) under `--tpu-stream
on`, and under `auto` (the default) when the DNA file is larger than
32 MiB (`wants_stream`); both round-robin the batches over the engines
(fasim_tpu/cli.py:118-149).  `-F` (exact SIM) runs on every engine; with
`--tpu-sim-device true` (or FASIM_SIM_DEVICE=1) the cuda and torch
engines run its forward scan on their device (kernels/sim_dev.py: K8 on
the card, its plain version on the CPU) and the host replays the
qualifying cells; the numpy engine's per-segment path ignores the switch,
as the JAX package's does.  More than one host: `python -m
fasim_tpu_torch.dist.runner` with the same flags.

`--tpu-profile true` (or FASIM_PROFILE=1) prints `profiling.STAGES`'
report as one `FASIM_PROFILE {...}` line on stderr: each stage's
seconds and calls, and the `n_` counts of work (batches, saturated
batches, scan and window cells, window rows, peaks, winners).
FASIM_TRACE=<path> writes the job's spans (stages with their threads and
parents) there as a Chrome trace (profiling.py).
"""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np
import torch

from .config import Params, TpuConfig


def _atoi(s: str) -> int:
    """C atoi: optional sign + leading digits, 0 otherwise."""
    s = s.strip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j])


_VALUE_FLAGS = {
    "f1": ("file1path", str), "f": ("file1path", str),
    "f2": ("file2path", str), "s": ("file2path", str),
    "O": ("outpath", str),
    "r": ("rule", _atoi),
    "c": ("cut_length", _atoi),
    "m": ("min_score", _atoi),
    "t": ("strand", _atoi),
    "i": ("min_identity", _atoi),       # atoi despite float field (:340)
    "S": ("min_stability", _atoi),      # atoi despite float field (:343)
    "ni": ("nt_min", _atoi), "y": ("nt_min", _atoi),
    "na": ("nt_max", _atoi), "z": ("nt_max", _atoi),
    "pc": ("penalty_c", _atoi), "Y": ("penalty_c", _atoi),
    "pt": ("penalty_t", _atoi), "Z": ("penalty_t", _atoi),
    "o": ("overlap_length", _atoi),
    "ds": ("c_distance", _atoi), "D": ("c_distance", _atoi),
    "lg": ("c_length", _atoi), "E": ("c_length", _atoi),
    "cn": ("corenum", _atoi), "C": ("corenum", _atoi),
}


def parse_args(argv: list[str]) -> tuple[Params, TpuConfig]:
    p = Params()
    tpu = TpuConfig()
    i = 0
    if not argv:
        show_help()
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            i += 1
            continue
        name = a.lstrip("-")
        if name == "h" or name == "help":
            show_help()
        elif name == "d":
            p.detail_output = True
            i += 1
        elif name == "F":
            p.do_fast_sim = False
            i += 1
        elif name.startswith("tpu-"):
            key = name[4:].replace("-", "_")
            if not hasattr(tpu, key):
                sys.exit(f"unknown flag --{name}")
            cur = getattr(tpu, key)
            val = argv[i + 1]
            setattr(tpu, key, type(cur)(val) if not isinstance(cur, bool)
                    else val.lower() in ("1", "true", "yes"))
            i += 2
        elif name in _VALUE_FLAGS:
            field, conv = _VALUE_FLAGS[name]
            if i + 1 >= len(argv):
                sys.exit(f"flag -{name} requires a value")
            setattr(p, field, conv(argv[i + 1]))
            i += 2
        else:
            sys.exit(f"unknown flag {a}")
    return p, tpu


def show_help() -> None:
    print("fasim_tpu_torch — triplex scanner on PyTorch and CUDA "
          "(Fasim-LongTarget compatible)\n"
          "usage: python -m fasim_tpu_torch.cli -f1 DNA.fa -f2 RNA.fa "
          "-O outdir [-r N] [-c 5000] [-t 0] [-o 100]\n"
          "       [-i 60] [-S 1] [-ni 20] [-na 100000] [-pc 0] [-pt -1000] "
          "[-ds 15] [-lg 50] [-F] [-C N]\n"
          "engine: --tpu-engine cuda (default) | torch (CPU) | numpy "
          "(per-segment golden)\n"
          "other: --tpu-dp-devices N (0: every GPU)  "
          "--tpu-segments-per-batch 64  "
          "--tpu-max-inflight 4  "
          "--tpu-stream auto|on|off  --tpu-sim-device true  "
          "--tpu-stdout-compat true  --tpu-profile true\n"
          "env: FASIM_PROFILE=1 (as --tpu-profile true: one FASIM_PROFILE "
          "JSON line on stderr, stage seconds and n_ counts of work)  "
          "FASIM_TRACE=path (the job's spans as a Chrome trace)")
    sys.exit(1)


def make_engine(tpu: TpuConfig, rna: np.ndarray):
    """The engines for `--tpu-engine`, one a device, for the drivers'
    round-robin (fasim_tpu/cli.py:make_engine), or None for the NumPy
    golden path.  cuda: cuda:0 to cuda:k-1, k the devices this process
    sees, or at most `--tpu-dp-devices` N when N > 0; torch: max(1, N)
    engines on the CPU."""
    from .kernels.engine import TorchScanEngine

    which = tpu.engine
    if which in ("auto", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("--tpu-engine cuda: no CUDA device "
                               "(torch.cuda.is_available() is false); use "
                               "--tpu-engine torch for the CPU")
        k = torch.cuda.device_count()
        if tpu.dp_devices > 0:
            k = min(k, tpu.dp_devices)
        return [TorchScanEngine(rna, device=f"cuda:{i}") for i in range(k)]
    if which == "torch":
        return [TorchScanEngine(rna, device="cpu")
                for _ in range(max(1, tpu.dp_devices))]
    if which == "numpy":
        return None
    sys.exit(f"unknown engine {which!r} (cuda|torch|numpy)")


STREAM_AUTO_BYTES = 32 * 1024 * 1024


def wants_stream(tpu: TpuConfig, path: str) -> bool:
    """Whether `--tpu-stream` picks the streaming driver for the DNA file
    at `path`: always under `on`, under `auto` when the file is larger
    than 32 MiB (fasim_tpu/cli.py:188-191), never otherwise."""
    return tpu.stream == "on" or (
        tpu.stream == "auto" and os.path.getsize(path) > STREAM_AUTO_BYTES)


def main(argv: list[str] | None = None) -> int:
    from .kernels.batch_np import numpy_engine
    from .profiling import STAGES
    from .scan.batched import scan_file_batched, scan_file_stream
    from .scan.pipeline import scan_file

    p, tpu = parse_args(sys.argv[1:] if argv is None else argv)
    if tpu.sim_device:
        os.environ["FASIM_SIM_DEVICE"] = "1"

    def scan(p: Params, rna: np.ndarray):
        with STAGES.timer("engine_setup"):
            engine = make_engine(tpu, rna)
        if engine is None:
            return scan_file(p, engine=numpy_engine)
        runner = (scan_file_stream if wants_stream(tpu, p.file1path)
                  else scan_file_batched)
        return runner(p, engine, batch_pairs=tpu.segments_per_batch,
                      max_inflight=tpu.max_inflight)

    return run(p, tpu, scan)


def run(p: Params, tpu: TpuConfig, scan) -> int:
    """One run: the reference's stdout lines around
    `scan(p, rna) -> (records, lnc_name, rna, triplexes)` and the output
    files (records may be streamed `RecordMeta`s and triplexes a
    `TriplexStore`).  `main` passes the scan `--tpu-engine` picks; a
    caller may pass another driver or engine (chip_smoke.py runs the
    per-segment path on the card through here)."""
    from .profiling import STAGES

    profile = tpu.profile or os.environ.get("FASIM_PROFILE", "") not in ("",
                                                                         "0")
    if profile:
        STAGES.start_run()
    with STAGES.job():
        _run(p, tpu, scan)
    if profile:
        import json

        print("FASIM_PROFILE " + json.dumps(STAGES.report()),
              file=sys.stderr)
    return 0


def _run(p: Params, tpu: TpuConfig, scan) -> None:
    """`run`'s body, inside the job's span."""
    from .io import fasta
    from .post.output import print_result
    from .profiling import STAGES

    print(f"Searching triplexes using {'Fasim' if p.do_fast_sim else 'Sim'}")
    t_start = time.process_time()
    with STAGES.timer("read_input"):
        lnc_probe, rna_probe = fasta.read_rna(p.file2path)
    if tpu.stdout_compat:
        # the reference interleaves these with the scan; the final stream
        # is identical when printed up front (record/segment order)
        print(lnc_probe)
        for rec in fasta.iter_dna(p.file1path):
            _, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                           p.overlap_length)
            for s in starts:
                print(f"dnaPos = {s}")
    records, lnc_name, rna, tlist = scan(p, rna_probe)
    first = records[0]
    # a streamed record keeps its length, not its sequence
    dna_size = (first.seq_len if hasattr(first, "seq_len")
                else len(first.seq))
    with STAGES.timer("output"):
        print_result(p, first.species, lnc_name, tlist, first.chro_tag,
                     dna_size, first.start_genome,
                     stdout_compat=tpu.stdout_compat)
    print("finished normally")
    if tpu.stdout_compat:
        # reference: clock()-based CPU seconds (never byte-compared)
        print(f"Running time is {time.process_time() - t_start:.6g}")


def entry() -> None:
    """`python -m fasim_tpu_torch.cli`: `main`, then exit with its status.
    When the scan watchdog fires, the process ends at once with status 1:
    the wedged thread never returns, and a normal interpreter exit would
    wait for it (concurrent.futures joins its worker threads at exit)."""
    from .scan.batched import WatchdogError

    try:
        code = main()
    except WatchdogError:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.exit(code)


if __name__ == "__main__":
    entry()
