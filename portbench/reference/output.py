"""printResult (Fasim-LongTarget.cpp:797-845): the RNA-axis density
clustering (cluster_triplex, :600-691), the -TFOsorted rows in the order
of std::sort by class (:813) and the -TFOclass1/2 bedGraphs
(print_cluster, :694-795), as text.

The clustering keeps the reference's results where its loops would be
slow in Python: the density map is an array over the RNA axis, and a
round's re-scan, which re-inserts every key from 0 to the largest as 0
(the operator[] insertions), is a search for the first largest value.
"""

from __future__ import annotations

import numpy as np

from . import stdsort

HEADER = ("QueryStart\tQueryEnd\tStartInSeq\tEndInSeq\tDirection\t"
          "Chr\tStartInGenome\tEndInGenome\tMeanStability\t"
          "MeanIdentity(%)\tStrand\tRule\tScore\tNt(bp)\tClass\t"
          "MidPoint\tCenter\tTFO sequence\tTTS sequence\n")


def _fmt(v: float) -> str:
    """ostream << float: 6 significant digits."""
    return f"{float(np.float32(v)):.6g}"


def _strand(reverse: int, strand: int) -> str:
    return {(1, 0): "ParaPlus", (1, 1): "ParaMinus", (-1, 1): "AntiMinus",
            (-1, 0): "AntiPlus"}.get((reverse, strand), "")


def cluster(dd: int, length: int, hits: list, levels: int = 5):
    """(middle, motif, center) of each hit and the coverage map of each
    class 1..levels."""
    n = len(hits)
    middle = [0] * n
    motif = [0] * n
    center = [0] * n
    near: dict[int, int] = {}
    max_near = max_pos = 0
    find = False
    for k, h in enumerate(hits):
        if h.nt <= length:
            continue
        mid = (h.stari + h.endi) // 2
        middle[k] = mid
        near.setdefault(mid, 0)
        for i in range(-dd, dd + 1):
            pos = mid + i
            if i > 0:
                near[pos] = near.get(pos, 0) + (dd - i)
            elif i < 0:
                near[pos] = near.get(pos, 0) + (dd + i)
            else:
                near.setdefault(pos, 0)
            if near[pos] > max_near:
                max_near = near[pos]
                max_pos = pos
                find = True
    classes: list[dict[int, int]] = [dict() for _ in range(levels + 1)]
    if not near:
        return middle, motif, center, classes
    lo = min(near)
    hi = max(near)
    val = np.zeros(hi - lo + 1, np.int64)
    present = np.zeros(hi - lo + 1, bool)
    for key, v in near.items():
        val[key - lo] = v
        present[key - lo] = True
    # a hit of nt <= length keeps middle 0, and a round whose range holds
    # 0 takes it as well (the reference compares every triplex's middle)
    by_mid: dict[int, list[int]] = {}
    for k in range(n):
        by_mid.setdefault(middle[k], []).append(k)
    theclass = 1
    while find:
        for i in range(max_pos - dd, max_pos + dd + 1):
            for k in by_mid.get(i, ()):
                if motif[k] != 0:
                    continue
                motif[k] = theclass
                center[k] = max_pos
                if theclass > levels:
                    continue
                h = hits[k]
                cmap = classes[theclass]
                a, b = ((h.starj, h.endj) if h.endj > h.starj
                        else (h.endj, h.starj))
                for j in range(a, b):
                    cmap[j] = cmap.get(j, 0) + 1
            if lo <= i <= hi:
                val[i - lo] = 0
                present[i - lo] = False
        find = False
        keys = np.flatnonzero(present)
        if len(keys):
            top = int(keys[-1]) + lo
            if top >= 0:
                seg = val[-lo if lo < 0 else 0: top - lo + 1]
                start = max(lo, 0)
                best = int(seg.argmax()) if len(seg) else 0
                if len(seg) and seg[best] > 0:
                    max_pos = best + start
                    find = True
                present[max(0, -lo): top - lo + 1] = True
        theclass += 1
    return middle, motif, center, classes


def tfosorted(hits: list, middle, motif, center) -> str:
    order = [(motif[k], k) for k in range(len(hits))]
    stdsort.sort(order, lambda a, b: a[0] < b[0])
    out = [HEADER]
    for _, k in order:
        if motif[k] == 0:
            continue
        t = hits[k]
        d = "R" if t.starj < t.endj else "L"
        out.append(
            f"{t.stari}\t{t.endi}\t{t.starj}\t{t.endj}\t{d}\t{t.chr}\t"
            f"{t.genomestart}\t{t.genomeend}\t{_fmt(t.tri_score)}\t"
            f"{_fmt(t.identity)}\t{_strand(t.reverse, t.strand)}\t"
            f"{t.rule}\t{_fmt(t.score)}\t{t.nt}\t{motif[k]}\t{middle[k]}\t"
            f"{center[k]}\t{t.stri_align}\t{t.strj_align}\n")
    return "".join(out)


def bedgraph(level: int, cmap: dict, start_genome: int, chro: str,
             dna_size: int, rna_name: str, dd: int, length: int) -> str:
    """print_cluster; start_genome is the first record's start - 1."""
    rows = []
    items = sorted(cmap.items())
    final = items[-1][0] + start_genome if items else 0
    k = 0
    count = 0
    n = len(items)
    while k < n:
        first0 = items[k][0]
        t1, t2 = items[k]
        if items[k][0] + start_genome == final:
            rows.append((first0 + start_genome - 1, t1 + start_genome, t2))
            break
        k += 1
        while abs(items[k][0] - t1) == 1 and items[k][1] == t2:
            if items[k][0] + start_genome == final:
                break
            t1, t2 = items[k]
            k += 1
        rows.append((first0 + start_genome - (2 if count == 0 else 1),
                     t1 + start_genome, t2))
        count += 1
        if abs(items[k][0] - t1) != 1:
            rows.append((t1 + start_genome, items[k][0] + start_genome - 1,
                         0))
    head = (f"browser position {chro}:{start_genome}-"
            f"{start_genome + dna_size}\n"
            "browser hide all\n"
            "browser pack refGene encodeRegions\n"
            "browser full altGraph\n"
            "# 300 base wide bar graph, ausoScale is on by default == "
            "graphing\n"
            "# limits will dynamically change to always show full range "
            "of data\n"
            "# in viewing window, priority = 20 position this as the "
            "second graph\n"
            "# Note, zero-relative, half-open coordinate system in use "
            "for bedGraph format\n"
            f"track type=bedGraph name='{rna_name} TTS ({level})' "
            f"description='{dd}-{length}' visibility=full "
            f"color=200,100,0 altColor=0,100,200 priority=20\n")
    return head + "".join(f"{chro}\t{a}\t{b}\t{c}\n" for a, b, c in rows)


def job_files(p, species: str, lnc_name: str, dna_name: str, hits: list,
              chro: str, dna_size: int, start_genome: int) -> dict:
    """{file name: text} of one job's output; dna_name is the -f1 path as
    given, whose last three characters (".fa") the names drop."""
    base = f"{species}-{lnc_name}-{dna_name[:-3]}"
    middle, motif, center, classes = cluster(p.c_distance, p.c_length, hits)
    files = {f"{base}-TFOsorted": tfosorted(hits, middle, motif, center)}
    for level in (1, 2):
        files[f"{base}-TFOclass{level}-{p.c_distance}-{p.c_length}"] = \
            bedgraph(level, classes[level], start_genome - 1, chro,
                     dna_size, lnc_name, p.c_distance, p.c_length)
    return files


STDOUT = "Searching triplexes using Fasim\nfinished normally\n"
