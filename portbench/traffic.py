"""The general job generator: a traffic mix is a data file of parameters,
and every mix goes through these functions.

A mix (`traffic/<name>.json`) gives `records_per_job`, the DNA records of
the configuration's file that one job scans, `jobs_written`, how many
jobs set-up writes to disk before the window, and `check_records`, how
many (job, record) pairs of the window the correctness check recomputes.

The window's jobs walk the configuration's records in seeded
permutations, one after another, `records_per_job` at a time, so every
seed scans the same records equally often, in another order and
grouping.  A record does not repeat within a job: one that would is kept
for the next job.
"""

from __future__ import annotations

import collections
import json
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent

WINDOW, WARMUP, SAMPLE = 0, 1, 2


def load_mix(name: str) -> dict:
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    for key in ("records_per_job", "jobs_written", "check_records"):
        if not isinstance(mix.get(key), int) or mix[key] < 1:
            raise ValueError(f"traffic mix {name}: {key} must be a "
                             "positive integer")
    return mix


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one use of the seed; any whole number >= 0."""
    return np.random.default_rng([int(seed), stream])


def jobs(n_records: int, per_job: int, gen: np.random.Generator):
    """Endless job specs: lists of record indices into the configuration's
    file, in the order the job's FASTA holds them."""
    if not 1 <= per_job <= n_records:
        raise ValueError(f"{per_job} records a job from {n_records}")
    queue: collections.deque = collections.deque()
    while True:
        job: list[int] = []
        taken: set[int] = set()
        kept: list[int] = []
        while len(job) < per_job:
            if not queue:
                queue.extend(int(i) for i in gen.permutation(n_records))
            r = queue.popleft()
            if r in taken:
                kept.append(r)
            else:
                job.append(r)
                taken.add(r)
        queue.extendleft(reversed(kept))
        yield job


def sample(done: list[list[int]], count: int, gen: np.random.Generator
           ) -> list[tuple[int, int]]:
    """`count` (job, position in the job) pairs drawn without replacement
    from the jobs `done`, in job order."""
    pairs = [(j, k) for j, spec in enumerate(done) for k in range(len(spec))]
    if not pairs:
        return []
    pick = gen.choice(len(pairs), size=min(count, len(pairs)), replace=False)
    return sorted(pairs[i] for i in pick)


def fasta_text(records, spec: list[int]) -> str:
    """The job's DNA file: its records with their own headers, one line
    of bases each, as the configuration's file holds them."""
    return "".join(f">{records[i].header}\n{records[i].text}\n"
                   for i in spec)


class RawRecord:
    """A record of a FASTA file as text: its header less '>', its bases."""

    def __init__(self, header: str, text: str):
        self.header = header
        self.text = text


def raw_records(path: Path) -> list[RawRecord]:
    out: list[RawRecord] = []
    head = None
    parts: list[str] = []
    for line in Path(path).read_text().splitlines():
        if line.startswith(">"):
            if head is not None:
                out.append(RawRecord(head, "".join(parts)))
            head, parts = line[1:], []
        else:
            parts.append(line.strip())
    if head is not None:
        out.append(RawRecord(head, "".join(parts)))
    return out
