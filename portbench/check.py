"""The comparison that decides a run's `correct`.

A job's answer is its output: the -TFOsorted file, the two -TFOclass
bedGraphs and stdout.  The plain reference (`reference/`) cannot rebuild
a whole job of 64 or 128 records in the time of a window, so it checks
the job in two stages:

* records: for a seeded sample of the window's (job, record) pairs it
  recomputes the record's triplexes from the job's own DNA file and the
  lncRNA (the threshold and column-max passes, preAlign's peaks, the
  Iden sweep's windows, the traceback, the stability, the dedup chain and
  the filters) and holds them, field for field and in order, against the
  triplexes the program passed to its output stage for that record;
* output: for every job of the window it rebuilds the files and stdout
  from the triplexes the program passed to its output stage (the
  clustering, the std::sort row order, the bedGraph encoding) and holds
  them, line for line, against what the program wrote.

The program's triplexes are read where `cli.run` hands them to
`post.output.print_result`.  Each number below is compared with its
limit; a run is correct when none exceeds it.
"""

from __future__ import annotations

import os
from pathlib import Path

from .reference import fasta as rfasta
from .reference import fastsim, output

LIMITS = {
    # jobs whose cli.main raised or returned another status than 0
    "jobs_failed": 0,
    # program triplexes that belong to no record of their job, or that
    # break the records' order
    "rows_unplaced": 0,
    # triplexes of the sampled records that the program and the
    # reference do not share (each side's extra rows; 1 when they share
    # all rows in another order)
    "record_rows_diff": 0,
    # lines of the output files and stdout that differ from those the
    # reference writes from the program's triplexes
    "output_lines_diff": 0,
}


class Job:
    """One call of cli.main in the window and what it left."""

    def __init__(self, spec: list[int], fasta: str, outdir: str):
        self.spec = spec
        self.fasta = fasta  # the -f1 argument, a name in the work dir
        self.outdir = outdir
        self.status: int | None = None
        self.error = ""
        self.triplexes: list | None = None
        self.stdout = ""


def hit_of(t) -> fastsim.Hit:
    """A program triplex as the reference's row."""
    return fastsim.Hit(
        stari=int(t.stari), endi=int(t.endi), starj=int(t.starj),
        endj=int(t.endj), strand=int(t.strand), reverse=int(t.reverse),
        rule=int(t.rule), nt=int(t.nt), score=float(t.score),
        identity=float(t.identity), tri_score=float(t.tri_score),
        stri_align=str(t.stri_align), strj_align=str(t.strj_align),
        chr=str(t.chr), genomestart=int(t.genomestart),
        genomeend=int(t.genomeend))


def split(records: list, hits: list) -> tuple[list[list], int]:
    """The hits of each record of a job (a hit's record is the one
    whose chroTag and start hold it: genomestart - starj + 1 is the
    record's start), and the count of hits that fit no record or come
    out of the records' order."""
    where = {(r.chro_tag, r.start_genome): k for k, r in enumerate(records)}
    out: list[list] = [[] for _ in records]
    bad = 0
    last = 0
    for h in hits:
        k = where.get((h.chr, h.genomestart - h.starj + 1))
        if k is None or k < last:
            bad += 1
            continue
        last = k
        out[k].append(h)
    return out, bad


def rows_diff(prog: list, ref: list) -> int:
    a = [h.key() for h in prog]
    b = [h.key() for h in ref]
    if a == b:
        return 0
    rest = list(b)
    extra = 0
    for k in a:
        if k in rest:
            rest.remove(k)
        else:
            extra += 1
    return (extra + len(rest)) or 1


def lines_diff(got: str, want: str) -> int:
    g = got.splitlines()
    w = want.splitlines()
    return sum(1 for x, y in zip(g, w) if x != y) + abs(len(g) - len(w))


def job_records(workdir: str, job: Job) -> list:
    return rfasta.read_dna(os.path.join(workdir, job.fasta))


def output_diff(p: fastsim.Params, workdir: str, lnc_name: str,
                job: Job) -> int:
    """Lines in which the job's files and stdout differ from the
    reference's output of the program's own triplexes."""
    records = job_records(workdir, job)
    first = records[0]
    hits = [hit_of(t) for t in job.triplexes or []]
    want = output.job_files(p, first.species, lnc_name, job.fasta, hits,
                            first.chro_tag, len(first.seq),
                            first.start_genome)
    n = lines_diff(job.stdout, output.STDOUT)
    written = set(os.listdir(job.outdir))
    for name, text in want.items():
        got = (Path(job.outdir, name).read_text() if name in written
               else "")
        n += lines_diff(got, text)
    for name in written - set(want):
        n += len(Path(job.outdir, name).read_text().splitlines())
    return n


def reference_rows(p: fastsim.Params, workdir: str, rna, jobs: list[Job],
                   pairs: list[tuple[int, int]], device,
                   rnd=fastsim.f32) -> dict:
    """The reference's triplexes of each sampled (job, position) pair,
    all sampled records in one batch."""
    recs = []
    for j, k in pairs:
        recs.append(job_records(workdir, jobs[j])[k])
    rows = fastsim.record_hits(p, rna, recs, device, rnd=rnd)
    return dict(zip(pairs, rows))


def decide(p: fastsim.Params, workdir: str, lnc_path: str, jobs: list[Job],
           pairs: list[tuple[int, int]], device) -> dict:
    """The numbers compared, each {"value", "limit"}."""
    lnc_name, rna = rfasta.read_rna(lnc_path)
    failed = sum(1 for job in jobs if job.status != 0)
    unplaced = 0
    prog: dict = {}
    for j, job in enumerate(jobs):
        per, bad = split(job_records(workdir, job),
                         [hit_of(t) for t in job.triplexes or []])
        unplaced += bad
        for k, rows in enumerate(per):
            prog[(j, k)] = rows
    ref = reference_rows(p, workdir, rna, jobs, pairs, device)
    diff = sum(rows_diff(prog[pair], ref[pair]) for pair in pairs)
    out_diff = sum(output_diff(p, workdir, lnc_name, job) for job in jobs
                   if job.status == 0)
    values = {"jobs_failed": failed, "rows_unplaced": unplaced,
              "record_rows_diff": diff, "output_lines_diff": out_diff}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def correct(numbers: dict) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
