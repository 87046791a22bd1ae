"""FASTA reading and segmenting as Fasim-LongTarget does it.

readRna (Fasim-LongTarget.cpp:174-200), readDna with the per-record reset
of the legacy reader (:202-267, fasim-LongTarget.cpp:224-226), the header
scanner (:226-256), cutSequence (fastsim.h:71-90) and sameSeq (:873-933).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Record:
    species: str
    chro_tag: str
    start_genome: int
    seq: np.ndarray  # uint8


def _strip(line: str) -> str:
    return line.replace("\r", "").replace("\n", "")


def read_rna(path: str) -> tuple[str, np.ndarray]:
    """(name, sequence): the first line less '>' is the name."""
    with open(path) as f:
        lines = f.read().split("\n")
    name = _strip(lines[0].replace(">", ""))
    seq = "".join(_strip(line) for line in lines[1:])
    return name, np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)


def parse_header(line: str) -> tuple[str, str, int]:
    """'>species|chroTag|start-end': text before the first '|' is the
    species, before the second the chroTag, and each '-' after that takes
    the text so far as startGenome (atoi semantics)."""
    species = chro = ""
    start = "0"
    bars = 0
    info = ""
    for ch in line:
        if ch == ">":
            info = ""
        elif ch == "|" and bars == 0:
            species, info, bars = info, "", 1
        elif ch == "|" and bars == 1:
            chro, info, bars = info, "", 2
        elif ch == "-" and bars == 2:
            start, info = info, ""
        else:
            info += ch
    try:
        sg = int(start.strip() or "0")
    except ValueError:
        sg = 0
    return species, chro, sg


def read_dna(path: str) -> list[Record]:
    records = []
    head = ("", "", 0)
    seq = ""
    with open(path) as f:
        for line in f.readlines():
            if seq != "" and line.startswith(">"):
                records.append(Record(*head, _u8(seq)))
                seq = ""
            if line.startswith(">"):
                head = parse_header(line.rstrip("\n"))
            else:
                seq += _strip(line)
    records.append(Record(*head, _u8(seq)))
    return records


def _u8(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("latin-1"), dtype=np.uint8)


def cut_sequence(seq: np.ndarray, cut: int, overlap: int
                 ) -> tuple[list[np.ndarray], list[int]]:
    """Windows of `cut` bytes at a stride of cut - overlap."""
    segs, starts = [], []
    pos = 0
    while pos < len(seq):
        segs.append(seq[pos:pos + cut])
        starts.append(pos)
        pos += cut - overlap
    return segs, starts


def same_seq(seq: np.ndarray) -> bool:
    """A homopolymer of one of A C G T U N."""
    return any(bool(np.all(seq == c)) for c in b"ACGTUN")
