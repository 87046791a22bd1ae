"""Pairing-rule transforms, encoders and scoring tables.

The reference enumerates 24 Hoogsteen / reverse-Hoogsteen pairing rules, each
a 10-character code "SSSSS TTTTT" mapping source letters ATGCN to substitution
targets (rules.h:6-53, transferString rules.h:94-318).  Here every transform is
a precomputed 256-entry uint8 LUT applied with one vectorized gather, and the
scan enumeration (6 para x 2 orientations + 18 anti x 2 orientations = 48
scans per segment, Fasim-LongTarget.cpp:406-585) is a static table.

Two *different* alphabets/score matrices exist and must not be unified
(SURVEY.md "Threshold/scan engine mismatch"):

  * threshold engine (stats.h): 17-letter nascii alphabet collapsed by cg_str
    to {A,C,G,T,U,N}; npam scores (match 5, mismatch -4, U~T, N row -1);
  * scan engine (SSW, ssw_cpp.cpp:13-26): 5-letter {A,C,G,T,N} with the fork
    quirk 'U' -> 'A'; match 5 mismatch -4, N row -4.
"""

from __future__ import annotations

import numpy as np

# --- rule code strings (rules.h:6-53) --------------------------------------
# Index 0..4 = source alphabet ATGCN, index 5..9 = substitution targets.
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
    """256-entry byte->byte LUT for one rule code; unknown chars -> 'N'
    (rules.h:308-311)."""
    lut = np.full(256, ord("N"), dtype=np.uint8)
    for src, dst in zip(code[:5], code[5:]):
        lut[ord(src)] = ord(dst)
    return lut


def _choose_code(strand: int, para: int, rule: int) -> str:
    """Rule-code dispatch of transferString (rules.h:99-280).

    para >= 0: strand 0 -> PARARULE{rule}, else PARARULE{rule}REV.
    para < 0 : strand 1 -> ANTIRULE{rule}, else ANTIRULE{rule}REV.
    """
    if para >= 0:
        table = PARA_RULES if strand == 0 else PARA_RULES_REV
    else:
        table = ANTI_RULES if strand == 1 else ANTI_RULES_REV
    return table[rule - 1]


_LUT_CACHE: dict[tuple[int, int, int], np.ndarray] = {}


def transfer_lut(strand: int, para: int, rule: int) -> np.ndarray:
    key = (strand, 1 if para >= 0 else -1, rule)
    if key not in _LUT_CACHE:
        _LUT_CACHE[key] = _rule_lut(_choose_code(strand, para, rule))
    return _LUT_CACHE[key]


def transfer_string(seq: np.ndarray, strand: int, para: int, rule: int) -> np.ndarray:
    """Vectorized transferString on a uint8 sequence array."""
    return transfer_lut(strand, para, rule)[seq]


_COMP_LUT = np.zeros(256, dtype=np.uint8)  # complement drops unknown chars
for _s, _d in zip(b"ACGTN", b"TGCAN"):
    _COMP_LUT[_s] = _d


def complement(seq: np.ndarray) -> np.ndarray:
    """Complement; characters outside ACGTN are *dropped* (rules.h:59-87
    falls through the switch without appending)."""
    out = _COMP_LUT[seq]
    return out[out != 0]


def reverse(seq: np.ndarray) -> np.ndarray:
    return seq[::-1]


# --- scan enumeration --------------------------------------------------------
# Each scan = (strand, para, rule, transform(seg) spec, source(seg) spec).
# Order matters for output parity: the reference iterates para rules 1..6 with
# {forward, reversed} then anti rules 1..18 with {complement, reverse}
# (Fasim-LongTarget.cpp:406-585).
#
# src_kind encodes how strSrc (the untransformed sequence handed to stability
# scoring) is derived from the segment:
#   "fwd"     : segment as-is
#   "revcomp" : complement then reverse       (para, reversed orientation)
#   "comp"    : complement                    (anti, strand 1)
#   "rev"     : reverse                       (anti, strand 0)
# xform_kind encodes how the aligned (transformed) string is built:
#   "t"  : transfer(seq, strand, para, rule)
#   "tr" : transfer(...) then reverse
SCAN_TABLE: list[dict] = []
for _r in range(1, 7):
    SCAN_TABLE.append(dict(strand=0, para=1, rule=_r, xform="t", src="fwd"))
    SCAN_TABLE.append(dict(strand=1, para=1, rule=_r, xform="tr", src="revcomp"))
for _r in range(1, 19):
    SCAN_TABLE.append(dict(strand=1, para=-1, rule=_r, xform="t", src="comp"))
    SCAN_TABLE.append(dict(strand=0, para=-1, rule=_r, xform="tr", src="rev"))


def scan_list(rule: int, strand: int) -> list[dict]:
    """Scans to run, honoring -r (single rule) and -t (strand selection)
    (Fasim-LongTarget.cpp:404-585)."""
    scans = []
    if strand >= 0:
        para = [s for s in SCAN_TABLE if s["para"] == 1]
        if rule == 0:
            scans += para
        elif 0 < rule < 7:
            scans += [s for s in para if s["rule"] == rule]
    if strand <= 0:
        anti = [s for s in SCAN_TABLE if s["para"] == -1]
        if rule == 0:
            scans += anti
        else:
            scans += [s for s in anti if s["rule"] == rule]
    return scans


def make_scan_strings(segment: np.ndarray, scan: dict) -> tuple[np.ndarray, np.ndarray]:
    """(transformed, source) uint8 strings for one scan of one segment,
    exactly as LongTarget builds seq2/strSrc (Fasim-LongTarget.cpp:410-583)."""
    seq2 = transfer_string(segment, scan["strand"], scan["para"], scan["rule"])
    if scan["xform"] == "tr":
        seq2 = reverse(seq2)
    src = scan["src"]
    if src == "fwd":
        s = segment
    elif src == "revcomp":
        s = reverse(complement(segment))
    elif src == "comp":
        s = complement(segment)
    else:  # "rev"
        s = reverse(segment)
    return seq2, s


# --- encoders ---------------------------------------------------------------
# Threshold engine: nascii (stats.h:201-209) then cg_str collapse
# (stats.h:306-334) => 6 effective codes. We use indices 0..5 for
# A,C,G,T,U,N respectively.
THRESH_ENC = np.full(256, 5, dtype=np.int8)  # default N
for _i, _c in enumerate(b"ACGTU"):
    THRESH_ENC[_c] = _i
    THRESH_ENC[_c + 32] = _i  # lowercase maps identically through nascii

# npam-derived 6x6 matrix over (A,C,G,T,U,N): match 5, T~U 5, ACGTU
# mismatch -4, N vs anything -1 (stats.h npam rows 1-5 and row 16).
THRESH_MAT = np.full((6, 6), -4, dtype=np.int32)
np.fill_diagonal(THRESH_MAT, 5)
THRESH_MAT[3, 4] = THRESH_MAT[4, 3] = 5   # T/U
THRESH_MAT[5, :] = -1
THRESH_MAT[:, 5] = -1
THRESH_MAT[5, 5] = -1

# Scan engine: SSW kBaseTranslation (ssw_cpp.cpp:13-26): A/a,U/u -> 0,
# C -> 1, G -> 2, T -> 3, everything else 4.
SSW_ENC = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate(b"ACGT"):
    SSW_ENC[_c] = _i
    SSW_ENC[_c + 32] = _i
SSW_ENC[ord("U")] = 0
SSW_ENC[ord("u")] = 0

# BuildSwScoreMatrix with match 5 / mismatch 4 (ssw_cpp.cpp:28-53,238-250).
SSW_MAT = np.full((5, 5), -4, dtype=np.int32)
for _i in range(4):
    SSW_MAT[_i, _i] = 5

# --- stability tables (sim.h:72-97) -----------------------------------------
# triplex_score(c1=source DNA char, c2=RNA char, Para).
_PARA_PAIRS = {
    ("A", "T"): 3.7, ("T", "G"): 2.8, ("G", "G"): 2.2, ("G", "T"): 2.4,
    ("G", "C"): 4.5, ("C", "T"): 2.6, ("C", "C"): 2.4,
}
_ANTI_PAIRS = {
    ("A", "A"): 3.0, ("A", "T"): 3.5, ("A", "C"): 1.0, ("T", "G"): 1.0,
    ("G", "A"): 1.0, ("G", "G"): 3.0, ("G", "C"): 3.0, ("C", "T"): 2.0,
    ("C", "C"): 1.0,
}


def _stab_table(pairs: dict) -> np.ndarray:
    t = np.zeros((256, 256), dtype=np.float32)
    for (c1, c2), v in pairs.items():
        t[ord(c1), ord(c2)] = np.float32(v)
    return t


STAB_PARA = _stab_table(_PARA_PAIRS)
STAB_ANTI = _stab_table(_ANTI_PAIRS)


def triplex_score(c1: int, c2: int, para: int) -> np.float32:
    """Stability of one (source char, RNA char) pair; 0 for all others
    including gaps (sim.h:72-97)."""
    return (STAB_PARA if para > 0 else STAB_ANTI)[c1, c2]
