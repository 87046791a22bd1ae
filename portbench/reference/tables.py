"""Rule transforms, encoders and scoring tables of Fasim-LongTarget.

A frozen copy of the tables the scanner uses (rules.h:6-53, stats.h npam,
ssw_cpp.cpp:13-53, sim.h:72-97), so that the benchmark's reference does not
read them from the program under test.
"""

from __future__ import annotations

import numpy as np

GAP_OPEN = 16
GAP_EXTEND = 4
# An 8-bit cell with bias 4 saturates when score + 4 >= 255 (stats.h:729,
# sswNew.cpp:386).
BYTE_SAT = 251
# fastSIM keeps at most this many triplexes a (segment, transform) pair.
TOP_N = 50

PARA_RULES = [
    "ATGCNTGGTN", "ATGCNTGCTN", "ATGCNTGTTN",
    "ATGCNTGGCN", "ATGCNTGCCN", "ATGCNTGTCN",
]
PARA_RULES_REV = [
    "ATGCNGTTGN", "ATGCNGTTCN", "ATGCNGTTTN",
    "ATGCNGTCGN", "ATGCNGTCCN", "ATGCNGTCTN",
]
ANTI_RULES = [
    "ATGCNGTTGN", "ATGCNGTTCN", "ATGCNGTTAN",
    "ATGCNGTCGN", "ATGCNGTCCN", "ATGCNGTCAN",
    "ATGCNGATGN", "ATGCNGATCN", "ATGCNGATAN",
    "ATGCNGACGN", "ATGCNGACCN", "ATGCNGACAN",
    "ATGCNGCTGN", "ATGCNGCTCN", "ATGCNGCTAN",
    "ATGCNGCCGN", "ATGCNGCCCN", "ATGCNGCCAN",
]
ANTI_RULES_REV = [
    "ATGCNTGGTN", "ATGCNTGCTN", "ATGCNTGATN",
    "ATGCNTGGCN", "ATGCNTGCCN", "ATGCNTGACN",
    "ATGCNAGGTN", "ATGCNAGCTN", "ATGCNAGATN",
    "ATGCNAGGCN", "ATGCNAGCCN", "ATGCNAGACN",
    "ATGCNCGGTN", "ATGCNCGCTN", "ATGCNCGATN",
    "ATGCNCGGCN", "ATGCNCGCCN", "ATGCNCGACN",
]


def _rule_lut(code: str) -> np.ndarray:
    """Byte -> byte map of one rule code; other bytes map to 'N'."""
    lut = np.full(256, ord("N"), dtype=np.uint8)
    for src, dst in zip(code[:5], code[5:]):
        lut[ord(src)] = ord(dst)
    return lut


def transfer_lut(strand: int, para: int, rule: int) -> np.ndarray:
    """transferString's rule dispatch (rules.h:99-280)."""
    if para >= 0:
        table = PARA_RULES if strand == 0 else PARA_RULES_REV
    else:
        table = ANTI_RULES if strand == 1 else ANTI_RULES_REV
    return _rule_lut(table[rule - 1])


_COMP = np.zeros(256, dtype=np.uint8)
for _s, _d in zip(b"ACGTN", b"TGCAN"):
    _COMP[_s] = _d


def complement(seq: np.ndarray) -> np.ndarray:
    """Complement; bytes outside ACGTN are dropped (rules.h:59-87)."""
    out = _COMP[seq]
    return out[out != 0]


# The 48 scans of a segment in the reference's order: para rules 1..6
# forward then reversed, anti rules 1..18 complement then reverse
# (Fasim-LongTarget.cpp:406-585).
SCANS: list[dict] = []
for _r in range(1, 7):
    SCANS.append(dict(strand=0, para=1, rule=_r, rev=False, src="fwd"))
    SCANS.append(dict(strand=1, para=1, rule=_r, rev=True, src="revcomp"))
for _r in range(1, 19):
    SCANS.append(dict(strand=1, para=-1, rule=_r, rev=False, src="comp"))
    SCANS.append(dict(strand=0, para=-1, rule=_r, rev=True, src="rev"))


def scan_list(rule: int, strand: int) -> list[dict]:
    """The scans -r and -t select (Fasim-LongTarget.cpp:404-585)."""
    out = []
    if strand >= 0:
        out += [s for s in SCANS if s["para"] == 1
                and (rule == 0 or (0 < rule < 7 and s["rule"] == rule))]
    if strand <= 0:
        out += [s for s in SCANS if s["para"] == -1
                and (rule == 0 or s["rule"] == rule)]
    return out


def scan_strings(segment: np.ndarray, scan: dict
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(transformed, source) bytes of one scan of one segment."""
    seq2 = transfer_lut(scan["strand"], scan["para"], scan["rule"])[segment]
    if scan["rev"]:
        seq2 = seq2[::-1]
    kind = scan["src"]
    if kind == "fwd":
        src = segment
    elif kind == "revcomp":
        src = complement(segment)[::-1]
    elif kind == "comp":
        src = complement(segment)
    else:
        src = segment[::-1]
    return np.ascontiguousarray(seq2), np.ascontiguousarray(src)


# Threshold pass (stats.h): codes A C G T U N; match 5, T~U 5, mismatch -4,
# N against anything -1.
THRESH_ENC = np.full(256, 5, dtype=np.int64)
for _i, _c in enumerate(b"ACGTU"):
    THRESH_ENC[_c] = _i
    THRESH_ENC[_c + 32] = _i
THRESH_MAT = np.full((6, 6), -4, dtype=np.int64)
np.fill_diagonal(THRESH_MAT, 5)
THRESH_MAT[3, 4] = THRESH_MAT[4, 3] = 5
THRESH_MAT[5, :] = -1
THRESH_MAT[:, 5] = -1

# Scan pass and window aligner (ssw_cpp.cpp:13-53): A/U 0, C 1, G 2, T 3,
# else 4; match 5, mismatch -4, N row -4.
SSW_ENC = np.full(256, 4, dtype=np.int64)
for _i, _c in enumerate(b"ACGT"):
    SSW_ENC[_c] = _i
    SSW_ENC[_c + 32] = _i
SSW_ENC[ord("U")] = 0
SSW_ENC[ord("u")] = 0
SSW_MAT = np.full((5, 5), -4, dtype=np.int64)
for _i in range(4):
    SSW_MAT[_i, _i] = 5

# Stability of a (source DNA char, RNA char) pair (sim.h:72-97).
_PARA_PAIRS = {
    ("A", "T"): 3.7, ("T", "G"): 2.8, ("G", "G"): 2.2, ("G", "T"): 2.4,
    ("G", "C"): 4.5, ("C", "T"): 2.6, ("C", "C"): 2.4,
}
_ANTI_PAIRS = {
    ("A", "A"): 3.0, ("A", "T"): 3.5, ("A", "C"): 1.0, ("T", "G"): 1.0,
    ("G", "A"): 1.0, ("G", "G"): 3.0, ("G", "C"): 3.0, ("C", "T"): 2.0,
    ("C", "C"): 1.0,
}


def _stab(pairs: dict) -> dict:
    return {(c1, c2): np.float32(v) for (c1, c2), v in pairs.items()}


STAB_PARA = _stab(_PARA_PAIRS)
STAB_ANTI = _stab(_ANTI_PAIRS)
