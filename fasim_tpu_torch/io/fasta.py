"""FASTA readers, segmenter and homopolymer gate.

Reader semantics follow the reference byte-for-byte with one deliberate fix:
the canonical readDna (Fasim-LongTarget.cpp:202-267) never resets its header
state `j` nor the sequence accumulator between records, which corrupts every
record after the first on multi-record files.  We implement the legacy
variant's correct per-record reset (fasim-LongTarget.cpp:224-226) — the
behavior SURVEY.md §0 fixes in the patched oracle.  On single-record files
the two are identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DnaRecord:
    species: str
    chro_tag: str
    start_genome: int
    seq: np.ndarray  # uint8


def _strip_crlf(line: str) -> str:
    return line.replace("\r", "").replace("\n", "")


def read_rna(path: str) -> tuple[str, np.ndarray]:
    """(lnc_name, sequence).  First line is the name (all chars except '>');
    remaining lines concatenated with CR/LF stripped (Fasim-LongTarget.cpp:
    174-200); the reference's main also strips CR/LF from the name
    (:124-125)."""
    with open(path, "r") as f:
        lines = f.read().split("\n")
    name = _strip_crlf(lines[0].replace(">", ""))
    seq = "".join(_strip_crlf(l) for l in lines[1:])
    return name, np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)


def _parse_header(line: str) -> tuple[str, str, int]:
    """Parse '>species|chroTag|start-end' with the reference's character
    scanner (Fasim-LongTarget.cpp:226-256): the text before the first '|'
    is species, before the second '|' is chroTag, and each '-' seen after
    that captures the accumulated text as startGenome (so 'a-b-c' ends with
    startGenome = 'b')."""
    species = ""
    chro_tag = ""
    start_genome = "0"
    j = 0
    info = ""
    for ch in line:
        if ch == ">":
            info = ""
            continue
        if ch == "|" and j == 0:
            species = info
            j += 1
            info = ""
            continue
        if ch == "|" and j == 1:
            chro_tag = info
            j += 1
            info = ""
            continue
        if ch == "-" and j == 2:
            start_genome = info
            info = ""
            continue
        info += ch
    try:
        sg = int(start_genome.strip() or "0")
    except ValueError:
        sg = 0  # atoi() returns 0 on garbage
    return species, chro_tag, sg


def read_dna(path: str) -> list[DnaRecord]:
    """Record flush happens when a new '>' header is seen and the running
    sequence is non-empty, plus once at EOF (mirrors the reference loop
    structure, with the legacy per-record reset)."""
    records: list[DnaRecord] = []
    species, chro_tag, sg = "", "", 0
    tmp = ""
    with open(path, "r") as f:
        for line in f.readlines():
            if tmp != "" and line.startswith(">"):
                records.append(DnaRecord(species, chro_tag, sg, _to_u8(tmp)))
                tmp = ""
            if line.startswith(">"):
                species, chro_tag, sg = _parse_header(line.rstrip("\n"))
            else:
                tmp += _strip_crlf(line)
    records.append(DnaRecord(species, chro_tag, sg, _to_u8(tmp)))
    return records


def iter_dna(path: str):
    """Streaming read_dna: yields one DnaRecord at a time, holding at
    most one record's sequence in memory (genome-scale inputs; identical
    parse semantics to read_dna)."""
    species, chro_tag, sg = "", "", 0
    parts: list[str] = []
    with open(path, "r") as f:
        for line in f:
            if parts and any(parts) and line.startswith(">"):
                yield DnaRecord(species, chro_tag, sg,
                                _to_u8("".join(parts)))
                parts = []
            if line.startswith(">"):
                species, chro_tag, sg = _parse_header(line.rstrip("\n"))
            else:
                parts.append(_strip_crlf(line))
    yield DnaRecord(species, chro_tag, sg, _to_u8("".join(parts)))


def _to_u8(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("latin-1"), dtype=np.uint8)


def cut_sequence(seq: np.ndarray, cut_length: int, overlap_length: int
                 ) -> tuple[list[np.ndarray], list[int]]:
    """Fixed windows with stride cut_length - overlap_length; the last window
    is short (fastsim.h:71-90)."""
    segs, starts = [], []
    pos = 0
    n = len(seq)
    while pos < n:
        segs.append(seq[pos:pos + cut_length])
        starts.append(pos)
        pos += cut_length
        pos -= overlap_length
    return segs, starts


_SAME_CHARS = [ord(c) for c in "ACGTUN"]


def same_seq(seq: np.ndarray) -> bool:
    """True if the segment is a single-letter homopolymer over ACGTUN
    (Fasim-LongTarget.cpp:873-933)."""
    return any(np.all(seq == c) for c in _SAME_CHARS)
