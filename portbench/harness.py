"""One run of one cell: set-up, the measured window, the reading of the
window's device record, the correctness check and the result line.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration's file (`configs/<config>.json`), its traffic mix
(`traffic/<mix>.json`) and each metric's reader (`metrics/<metric>.py`;
setup_s alone is timed here).  The window calls the program's own entry,
`fasim_tpu_torch.cli.main(argv)`, in this process, one job at a time.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import check, traffic
from .reference import fastsim
from .reference.tables import scan_list

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fasim_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: dict | None = None):
    """(workload entry, configuration, mix) of the cell `name`."""
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{', '.join(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    return cell, config, traffic.load_mix(cell["traffic"])


def params_of(config: dict) -> fastsim.Params:
    """The reference's parameters for the configuration's flags.  The
    port's own `--tpu-<name> <value>` pairs pick its drivers and engines
    and leave the output as it is, so the reference has nothing to take
    from them; they still go to cli.main (Runner.run)."""
    p = fastsim.Params()
    names = {"-r": "rule", "-c": "cut_length", "-t": "strand",
             "-o": "overlap_length", "-ni": "nt_min", "-na": "nt_max",
             "-i": "min_identity", "-S": "min_stability", "-pt": "penalty_t",
             "-pc": "penalty_c", "-ds": "c_distance", "-lg": "c_length"}
    flags = config["flags"]
    for k in range(0, len(flags), 2):
        if flags[k].startswith("--tpu-"):
            continue
        if flags[k] not in names:
            raise ValueError(f"the reference does not take {flags[k]}")
        setattr(p, names[flags[k]], int(flags[k + 1]))
    return p


def metric_readers(bench: dict, cell: str, section: str
                   ) -> list[tuple[dict, object]]:
    """(entry, module) of each metric of `section` ("end_to_end" or
    "per_layer") this cell reports; setup_s, which the harness times
    itself, has no module (None)."""
    out = []
    for m in bench[section]:
        if cell in m.get("workloads", [w["name"] for w in bench["workloads"]]):
            out.append((m, None if m["name"] == "setup_s" else
                        importlib.import_module(
                            f"portbench.metrics.{m['name']}")))
    return out


@contextlib.contextmanager
def redirected(out_path: str, err_path: str):
    """The program's standard output and error to files of their own:
    file descriptors 1 and 2 (its native code's prints) and sys.stdout
    and sys.stderr (its Python prints, wherever they pointed)."""
    saved_py = sys.stdout, sys.stderr
    sys.stdout.flush()
    sys.stderr.flush()
    saved_fd = os.dup(1), os.dup(2)
    out = open(out_path, "w", buffering=1)
    err = open(err_path, "w", buffering=1)
    os.dup2(out.fileno(), 1)
    os.dup2(err.fileno(), 2)
    sys.stdout, sys.stderr = out, err
    try:
        yield
    finally:
        sys.stdout, sys.stderr = saved_py
        out.close()
        err.close()
        os.dup2(saved_fd[0], 1)
        os.dup2(saved_fd[1], 2)
        os.close(saved_fd[0])
        os.close(saved_fd[1])


class Runner:
    """Writes a cell's job files and runs jobs through cli.main."""

    def __init__(self, config: dict, mix: dict, seed: int, workdir: str,
                 extra_argv: list[str]):
        self.config = config
        self.mix = mix
        self.workdir = workdir
        self.lnc = str(ROOT / config["lncrna"])
        self.records = traffic.raw_records(ROOT / config["dna"])
        self.extra = extra_argv
        per = mix["records_per_job"]
        n = len(self.records)
        self.window_specs = traffic.jobs(n, per,
                                         traffic.rng(seed, traffic.WINDOW))
        self.warm_spec = next(traffic.jobs(n, per,
                                           traffic.rng(seed, traffic.WARMUP)))
        self.count = 0
        self.written: list[check.Job] = []
        self.captured: list = []
        # (rows, seconds) of each streamed job's store read by capturing
        self.store_reads: list[tuple[int, float]] = []

    def write(self, spec: list[int]) -> check.Job:
        name = f"job{self.count:05d}.fa"
        self.count += 1
        Path(self.workdir, name).write_text(
            traffic.fasta_text(self.records, spec))
        outdir = os.path.join(self.workdir, name[:-3])
        os.makedirs(outdir)
        return check.Job(spec, name, outdir)

    def prepare(self) -> None:
        """Set-up: the window's first jobs' files."""
        for _ in range(self.mix["jobs_written"]):
            self.written.append(self.write(next(self.window_specs)))

    def next_job(self) -> check.Job:
        if self.written:
            return self.written.pop(0)
        return self.write(next(self.window_specs))

    def bases(self, job: check.Job) -> int:
        return sum(len(self.records[i].text) for i in job.spec)

    def run(self, job: check.Job) -> None:
        from fasim_tpu_torch import cli

        argv = [*self.config["flags"], *self.extra, "-f1", job.fasta,
                "-f2", self.lnc, "-O", job.outdir]
        before = len(self.captured)
        with redirected(job.outdir + ".out", job.outdir + ".err"):
            try:
                job.status = cli.main(argv)
            except BaseException as exc:  # noqa: BLE001 - a job's failure
                if isinstance(exc, KeyboardInterrupt):
                    raise
                job.status = -1
                job.error = f"{type(exc).__name__}: {exc}"
        job.stdout = Path(job.outdir + ".out").read_text()
        if len(self.captured) > before:
            job.triplexes = self.captured[-1]


@contextlib.contextmanager
def capturing(runner: Runner):
    """Keep what cli.run hands post.output.print_result: the list of
    triplexes the output stage writes, or, for a streamed job, the rows
    of its TriplexStore (store_rows), read before the output stage
    closes the store and removes its spill file."""
    from fasim_tpu_torch.post import output

    original = output.print_result

    def keep(p, species, lnc_name, tlist, *args, **kwargs):
        if isinstance(tlist, list):
            runner.captured.append(tlist)
        else:
            t0 = time.perf_counter()
            runner.captured.append(store_rows(tlist))
            runner.store_reads.append((len(tlist),
                                       time.perf_counter() - t0))
        return original(p, species, lnc_name, tlist, *args, **kwargs)

    output.print_result = keep
    try:
        yield
    finally:
        output.print_result = original


# the numeric columns of a TriplexStore that check.hit_of reads
STORE_COLUMNS = ("stari", "endi", "starj", "endj", "strand", "reverse",
                 "rule", "nt", "score", "identity", "tri_score",
                 "genomestart", "genomeend")


def store_rows(st) -> list:
    """The rows of a finalized post.store.TriplexStore in its row order
    (the order its output stage writes from), each with the store's
    numeric columns, chro(i) and strings(i), as check.hit_of reads a
    triplex.  A spilled store's strings are read through a mapping of
    the spill file of this function's own, closed before it returns, so
    the store is left as it was: its output stage opens its own."""
    import mmap
    import types

    own = None
    if st._spill is not None and st._mm is None and st._off:
        own = mmap.mmap(st._spill.fileno(), 0, access=mmap.ACCESS_READ)
        st._mm = own
    try:
        cols = {f: st.cols[f].tolist() for f in STORE_COLUMNS}
        rows = []
        for i in range(len(st)):
            a, b = st.strings(i)
            rows.append(types.SimpleNamespace(
                **{f: cols[f][i] for f in STORE_COLUMNS},
                stri_align=a, strj_align=b, chr=st.chro(i)))
    finally:
        if own is not None:
            st._mm = None
            own.close()
    return rows


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, extra_argv: list[str] = (),
             bench: dict | None = None, cell_spec=None,
             device: str = "cuda") -> tuple[dict, list[str]]:
    """One run: (result object, lines for stderr)."""
    import torch

    t_enter = time.perf_counter()
    bench = bench or manifest()
    cell, config, mix = cell_spec or load_cell(name, bench)
    params = params_of(config)
    # the cards the run was given: the cell's chips (run.py keeps no more
    # visible), each with an engine of the program's round-robin
    cards = cell["chips"] if device == "cuda" else 0
    from fasim_tpu_torch.profiling import STAGES

    lines: list[str] = []
    work = tempfile.mkdtemp(prefix="portbench-")
    cwd = os.getcwd()
    runner = Runner(config, mix, seed, work, list(extra_argv))
    jobs: list[check.Job] = []
    job_s: list[float] = []
    bases = 0
    prof = None
    try:
        os.chdir(work)
        with capturing(runner):
            warm = runner.write(runner.warm_spec)
            runner.prepare()
            t_files = time.perf_counter()
            runner.run(warm)
            if warm.status != 0:
                raise RuntimeError(f"the warm-up job failed: {warm.error}")
            shutil.rmtree(warm.outdir)
            for i in range(cards):
                torch.cuda.synchronize(i)
            runner.captured.clear()
            runner.store_reads.clear()
            t_warm = time.perf_counter()
            # every run records the card's work (the end-to-end metric
            # device_s_per_mbp reads it); a traced run also records the
            # host's operations, for the idle gaps' labels
            activities = [
                *([torch.profiler.ProfilerActivity.CPU] if trace else []),
                *([torch.profiler.ProfilerActivity.CUDA]
                  if device == "cuda" else [])]
            if activities:
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            STAGES.start_run()
            cpu0 = cpu_seconds()
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            with torch.profiler.record_function("portbench.window"):
                while True:
                    job = runner.next_job()
                    a = time.perf_counter()
                    with torch.profiler.record_function("portbench.job"):
                        runner.run(job)
                    b = time.perf_counter()
                    jobs.append(job)
                    job_s.append(b - a)
                    bases += runner.bases(job)
                    if b - t0 >= seconds:
                        break
            window_s = b - t0
            cpu1 = cpu_seconds()
            stages = STAGES.report()
            if prof is not None:
                prof.stop()
        peaks = [torch.cuda.max_memory_allocated(i) for i in range(cards)]
        record = {
            "window_s": window_s, "bases": bases, "jobs": len(jobs),
            "job_s": job_s, "stages": stages,
            "query_len": len(traffic.raw_records(ROOT / config["lncrna"])
                             [0].text),
            "transforms": len(scan_list(params.rule, params.strand)),
            "longest": max(max(len(runner.records[i].text)
                               for i in job.spec) for job in jobs),
            "trace": None,
        }
        record["segments"], record["scanned"] = scanned(params, runner, jobs)
        if prof is not None:
            from . import trace as tr

            record["trace"] = tr.read(prof)
            prof = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        pairs = traffic.sample([j.spec for j in jobs], mix["check_records"],
                               traffic.rng(seed, traffic.SAMPLE))
        c0 = time.perf_counter()
        numbers = check.decide(params, work, runner.lnc, jobs, pairs, device)
        check_s = time.perf_counter() - c0
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    failed = sum(1 for j in jobs if j.status != 0)
    for j in jobs:
        if j.status != 0:
            lines.append(f"job {j.fasta} failed: {j.error}")
    metrics: dict = {}
    section = "per_layer" if trace else "end_to_end"
    for entry, mod in metric_readers(bench, cell["name"], section):
        v = setup_s if mod is None else mod.read(record)
        if v is not None:
            metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
    device_info = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                 else "cpu"),
        "count": max(cards, 1), "memory_peak_bytes": max(peaks, default=0),
        "memory_peak_bytes_by_card": peaks}
    result = {"correct": check.correct(numbers), "attempted": len(jobs),
              "failed": failed, "metrics": metrics, "device": device_info}
    t = record["trace"]
    if trace and t is not None:
        device_info["busy_s"] = t["busy_s"]
        # keyed by the card's index as the profiler gives it
        device_info["busy_s_by_card"] = t["busy_s_by_card"]
        device_info["window_s"] = t["window_s"]
        top = sorted(t["kernels"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in top],
                               "idle_gaps": [[n[:160], s]
                                             for n, s in t["gaps"]]}
    if trace:
        lines.append(f"card power limit: {power_limit()}")
    lines.append(f"set-up {setup_s:.3f} s: to the harness (imports, CUDA) "
                 f"{t_enter - t_start:.3f} s, job files "
                 f"{t_files - t_enter:.3f} s, warm-up job "
                 f"{t_warm - t_files:.3f} s, profiler start "
                 f"{t0 - t_warm:.3f} s; this process's CPU {cpu0:.3f} s")
    lines.append(f"window {window_s:.3f} s, {len(jobs)} jobs, {bases} bases: "
                 f"{bases / window_s / 1e3:.4f} kbp/s on the host's clock; "
                 f"set-up {setup_s:.3f} s; the check {check_s:.3f} s")
    if t is not None:
        lines.append(f"card busy {t['busy_s']:.6f} s in the window, "
                     "summed over the cards: " + ", ".join(
                         f"card {c} {s:.6f} s"
                         for c, s in t["busy_s_by_card"].items()))
    if peaks:
        lines.append("memory peak by card: " + ", ".join(
            f"card {i} {n} B" for i, n in enumerate(peaks)))
    lines.append(host_load(cpu0, cpu1, window_s, job_s))
    lines.append(stage_shares(stages, window_s))
    lines.append(counters(stages))
    if runner.store_reads:
        lines.append(store_line(runner.store_reads))
    lines.append(f"records checked against the reference: {len(pairs)} "
                 f"of {sum(len(j.spec) for j in jobs)} in {len(jobs)} jobs")
    for k, n in numbers.items():
        lines.append(f"check {k}: {n['value']} (limit {n['limit']})")
    result["checks"] = numbers
    return result, lines


def scanned(p: fastsim.Params, runner: Runner, jobs: list
            ) -> tuple[int, int]:
    """(segments, bases) the window's scans covered: cutSequence cuts a
    record into windows of -c bases at a stride of -c less -o, the last
    one short, so overlaps are scanned twice."""
    step = p.cut_length - p.overlap_length
    segs = bases = 0
    for job in jobs:
        for i in job.spec:
            n = len(runner.records[i].text)
            for start in range(0, n, step):
                segs += 1
                bases += min(p.cut_length, n - start)
    return segs, bases


def cpu_seconds() -> float:
    """This process's CPU seconds, user and system, all threads."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def host_load(cpu0: float, cpu1: float, window_s: float, job_s: list) -> str:
    """A line on the host over the window: the cores this process kept
    busy and the spread of the job times, in order when there are few."""
    import statistics

    q = (statistics.quantiles(job_s, n=4) if len(job_s) > 1
         else [job_s[0]] * 3)
    return (f"host over the window: this process "
            f"{(cpu1 - cpu0) / window_s:.2f} cores of {os.cpu_count()}; "
            f"job seconds min {min(job_s):.4f} q1 {q[0]:.4f} median "
            f"{q[1]:.4f} q3 {q[2]:.4f} max {max(job_s):.4f}"
            + ("; in order " + " ".join(f"{t:.3f}" for t in job_s)
               if len(job_s) <= 64 else ""))


def stage_shares(stages: dict, window_s: float) -> str:
    """A line on the program's own stage timers (profiling.STAGES) over
    the window: each stage's seconds as a share of the window (the pool's
    busy-seconds can pass 100%)."""
    parts = [f"{k} {100 * v / window_s:.2f}%" for k, v in stages.items()
             if not k.startswith("n_") and k != "wall"]
    return "program stages over the window: " + (", ".join(parts) or "none")


def counters(stages: dict) -> str:
    """A line on the program's `n_` counts of work over the window."""
    parts = [f"{k} {v}" for k, v in stages.items() if k.startswith("n_")]
    return "program counters over the window: " + (", ".join(parts)
                                                    or "none")


def store_line(reads: list[tuple[int, float]]) -> str:
    """A line on the window's reads of streamed jobs' stores (capturing):
    host time inside the window, which the card's busy time leaves out."""
    rows = sum(n for n, _ in reads)
    secs = sum(s for _, s in reads)
    return (f"streamed stores read for the check: {len(reads)} jobs, "
            f"{rows} rows in {secs:.4f} s ({secs / len(reads):.4f} s a job, "
            f"{1e6 * secs / max(rows, 1):.2f} us a row)")


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"


def loaded_forbidden() -> list[str]:
    """Modules of a forbidden top-level name in sys.modules."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
