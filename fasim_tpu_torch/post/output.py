"""RNA-axis density clustering and byte-exact output writers.

Reproduces cluster_triplex (Fasim-LongTarget.cpp:600-691), printResult
(:797-845) and print_cluster (:694-795) including their quirks:

  * the cluster re-scan iterates `axis_map[i]` for i = 0..size, inserting
    zombie zero entries for every missing integer key; the net effect is
    "max density wins, lowest position breaks ties", scanning up to the
    largest key present at round start — zombies persist between rounds;
  * rows whose triplex was never captured by a density peak (motif 0) are
    suppressed (:819-822);
  * the TFOsorted row order comes from a non-stable std::sort by class —
    delegated to the native runtime for libstdc++-identical permutations;
  * print_cluster's run-length encoding emits the very first row with a
    start offset of -2 instead of -1 (:749-754), always emits the final
    map entry as its own row (:732-737), and inserts explicit zero rows
    across coverage gaps (:760-765);
  * bedGraph headers use the FIRST DNA record's chroTag/startGenome/length
    regardless of which records produced hits (main:164-166).
"""

from __future__ import annotations

import os

import numpy as np

from .. import native
from ..config import Params
from ..profiling import STAGES
from ..scan.pipeline import Triplex

_F32 = np.float32


def _fmt_f(v) -> str:
    """ostream << float: double promotion, 6 significant digits (%g)."""
    return f"{float(_F32(v)):.6g}"


def get_strand(reverse: int, strand: int) -> str:
    """getStrand (Fasim-LongTarget.cpp:851-871)."""
    if reverse == 1 and strand == 0:
        return "ParaPlus"
    if reverse == 1 and strand == 1:
        return "ParaMinus"
    if reverse == -1 and strand == 1:
        return "AntiMinus"
    if reverse == -1 and strand == 0:
        return "AntiPlus"
    return ""


def cluster_triplex(dd: int, length: int, tlist: list[Triplex],
                    class1: list[dict], class_level: int = 5) -> None:
    """cluster_triplex (Fasim-LongTarget.cpp:600-691).  Mutates tlist
    (middle/motif/center/neartriplex) and fills class1[1..class_level]
    coverage maps."""
    near: dict[int, int] = {}
    max_near = 0
    max_pos = 0
    find = 0
    warned = False
    for t in tlist:
        if t.nt > length:
            middle = (t.stari + t.endi) // 2
            t.middle = middle
            t.motif = 0
            near.setdefault(middle, 0)
            for i in range(-dd, dd + 1):
                pos = middle + i
                if pos < 0 and not warned:
                    # Reference UB: the key becomes (size_t)(negative int)
                    # (Fasim-LongTarget.cpp:624); its re-scan loop
                    # (i = 0..axis_map.size(), :680-688) then never passes
                    # the huge leftover key — it zombie-inserts every i
                    # until int overflow / OOM and produces no output
                    # (verified by source analysis; a genome scan must not
                    # die on one hit).  We keep the negative key: it is
                    # correctly erased by nearby cluster picks (erase
                    # wraps the same way, :675) and is never selected by
                    # the i >= 0 re-scan — i.e. the output the reference
                    # would produce with a sane loop bound.
                    import warnings

                    warnings.warn(
                        "cluster midpoint within c_distance of the RNA "
                        "start: reference behavior is a hang (size_t key "
                        "wrap); emitting sane-loop-bound output instead")
                    warned = True
                if i > 0:
                    near[pos] = near.get(pos, 0) + (dd - i)
                elif i < 0:
                    near[pos] = near.get(pos, 0) + (dd + i)
                else:
                    near.setdefault(pos, 0)
                if near.get(pos, 0) > max_near:
                    max_near = near[pos]
                    max_pos = pos
                    find = 1
            t.neartriplex = near[middle]
    theclass = 1
    while find:
        for i in range(max_pos - dd, max_pos + dd + 1):
            for t in tlist:
                if t.middle == i and t.motif == 0:
                    t.motif = theclass
                    t.center = max_pos
                    if theclass > class_level:
                        continue
                    if t.endj > t.starj:
                        for j in range(t.starj, t.endj):
                            class1[theclass][j] = class1[theclass].get(j, 0) + 1
                    else:
                        for j in range(t.endj, t.starj):
                            class1[theclass][j] = class1[theclass].get(j, 0) + 1
            near.pop(i, None)
        max_near = 0
        find = 0
        if near:
            max_key = max(near)
            for i in range(0, max_key + 1):
                v = near.get(i, 0)
                if v > max_near:
                    max_near = v
                    max_pos = i
                    find = 1
                near.setdefault(i, 0)  # zombie entry (operator[] insertion)
        theclass += 1


def write_tfosorted(path: str, tlist: list[Triplex]) -> None:
    """TFOsorted writer (printResult body, Fasim-LongTarget.cpp:808-829).
    tlist must already be clustered; row order is the native std::sort-by-
    class permutation."""
    order = native.sort_by_motif(np.array([t.motif for t in tlist], np.int32)
                                 if tlist else np.empty(0, np.int32))
    with open(path, "w") as f:
        f.write("QueryStart\tQueryEnd\tStartInSeq\tEndInSeq\tDirection\t"
                "Chr\tStartInGenome\tEndInGenome\tMeanStability\t"
                "MeanIdentity(%)\tStrand\tRule\tScore\tNt(bp)\tClass\t"
                "MidPoint\tCenter\tTFO sequence\tTTS sequence\n")
        for i in order:
            t = tlist[i]
            if t.motif == 0:
                continue
            d = "R" if t.starj < t.endj else "L"
            f.write(f"{t.stari}\t{t.endi}\t{t.starj}\t{t.endj}\t{d}\t"
                    f"{t.chr}\t{t.genomestart}\t{t.genomeend}\t"
                    f"{_fmt_f(t.tri_score)}\t{_fmt_f(t.identity)}\t"
                    f"{get_strand(t.reverse, t.strand)}\t{t.rule}\t"
                    f"{_fmt_f(t.score)}\t{t.nt}\t{t.motif}\t{t.middle}\t"
                    f"{t.center}\t{t.stri_align}\t{t.strj_align}\n")


def write_cluster(c_level: int, cmap: dict[int, int], start_genome: int,
                  chro_info: str, dna_size: int, rna_name: str,
                  distance: int, length: int, tfosorted_path: str,
                  c_tmp_dd: str, c_tmp_length: str) -> None:
    """print_cluster (Fasim-LongTarget.cpp:694-795).  start_genome is the
    caller-adjusted value (record start - 1, :834)."""
    class_name = (tfosorted_path[:-10] + "-TFOclass" + str(c_level) + "-"
                  + c_tmp_dd + "-" + c_tmp_length)
    rows: list[tuple[int, int, int]] = []
    items = sorted(cmap.items())
    final_genome = items[-1][0] + start_genome if items else 0
    k = 0
    map_count = 0
    n = len(items)
    while k < n:
        map_first0 = items[k][0]
        map_tmp1 = items[k][0]
        map_tmp2 = items[k][1]
        if items[k][0] + start_genome == final_genome:
            rows.append((map_first0 + start_genome - 1,
                         map_tmp1 + start_genome, map_tmp2))
            break
        k += 1
        while abs(items[k][0] - map_tmp1) == 1 and items[k][1] == map_tmp2:
            if items[k][0] + start_genome == final_genome:
                break
            map_tmp1 = items[k][0]
            map_tmp2 = items[k][1]
            k += 1
        if map_count == 0:
            rows.append((map_first0 + start_genome - 2,
                         map_tmp1 + start_genome, map_tmp2))
            map_count += 1
        else:
            rows.append((map_first0 + start_genome - 1,
                         map_tmp1 + start_genome, map_tmp2))
        if abs(items[k][0] - map_tmp1) != 1:
            rows.append((map_tmp1 + start_genome,
                         items[k][0] + start_genome - 1, 0))
    with open(class_name, "w") as f:
        f.write(f"browser position {chro_info}:{start_genome}-"
                f"{start_genome + dna_size}\n")
        f.write("browser hide all\n")
        f.write("browser pack refGene encodeRegions\n")
        f.write("browser full altGraph\n")
        f.write("# 300 base wide bar graph, ausoScale is on by default == "
                "graphing\n")
        f.write("# limits will dynamically change to always show full range "
                "of data\n")
        f.write("# in viewing window, priority = 20 position this as the "
                "second graph\n")
        f.write("# Note, zero-relative, half-open coordinate system in use "
                "for bedGraph format\n")
        f.write(f"track type=bedGraph name='{rna_name} TTS ({c_level})' "
                f"description='{distance}-{length}' visibility=full "
                f"color=200,100,0 altColor=0,100,200 priority=20\n")
        for gs, ge, lv in rows:
            f.write(f"{chro_info}\t{gs}\t{ge}\t{lv}\n")


def print_result(p: Params, species: str, lnc_name: str,
                 tlist: list[Triplex], chro_tag: str, dna_size: int,
                 start_genome: int, stdout_compat: bool = False) -> str:
    """printResult (Fasim-LongTarget.cpp:797-845).  Returns the TFOsorted
    path.  species/chro_tag/dna_size/start_genome come from the FIRST DNA
    record (main:164-166)."""
    if not isinstance(tlist, list):  # columnar TriplexStore (streaming)
        from .store import print_result_store

        return print_result_store(p, species, lnc_name, tlist, chro_tag,
                                  dna_size, start_genome, stdout_compat)
    file_name = p.file1path[: len(p.file1path) - 3]  # strips ".fa" (main:123)
    out_path = (p.outpath + "/" + species + "-" + lnc_name + "-"
                + file_name + "-TFOsorted")
    class1: list[dict[int, int]] = [dict() for _ in range(6)]
    with STAGES.timer("cluster_triplex"):
        cluster_triplex(p.c_distance, p.c_length, tlist, class1, 5)
    with STAGES.timer("write_tfosorted"):
        write_tfosorted(out_path, tlist)
    prev = "\x7f"
    for level in (1, 2):
        if stdout_compat:
            # print_cluster's uninitialized-buffer quirk (:697-698): the
            # char[3] prints stack garbage before sprintf — a stable
            # \x7f byte on the first call (verified identical across all
            # 8 committed golden stdouts), the previous level's digits on
            # later calls
            print(f"{prev}{level}")
            prev = str(level)
        with STAGES.timer("bedgraphs"):
            write_cluster(level, class1[level], start_genome - 1, chro_tag,
                          dna_size, lnc_name, p.c_distance, p.c_length,
                          out_path, str(p.c_distance), str(p.c_length))
    return out_path
