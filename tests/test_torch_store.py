"""The port's columnar hit store (`fasim_tpu_torch/post/store.py`): the
same hits written through the list path (`post.output.print_result`)
and through the store (`post.store.print_result_store`) give
byte-identical output files and stdout, with the alignment strings
spilled to a file and kept in RAM, over three `-C` buckets, for an empty
store, and when every alignment string is empty (with spilling on,
nothing is written to the spill file, so there is no mapping to read)."""

import dataclasses
import os

import numpy as np
import pytest

from fasim_tpu_torch.config import Params
from fasim_tpu_torch.post.output import print_result
from fasim_tpu_torch.post.store import TriplexStore, print_result_store
from fasim_tpu_torch.scan.pipeline import Triplex

_CHARS = np.frombuffer(b"ACGTU-", np.uint8)


def _records(rng, n_records: int, hits_per_record: int, strings: str):
    """n_records (chro, start_genome, hits) with coordinate-fixed hits
    clustered along the RNA axis; strings is "random", "mixed" (some
    empty) or "empty"."""
    out = []
    for ri in range(n_records):
        chro = f"chr{ri + 1}"
        start_genome = int(rng.integers(1, 10 ** 7))
        hits = []
        for _ in range(int(rng.integers(0, hits_per_record + 1))):
            stari = int(rng.integers(40, 400))
            nt = int(rng.integers(20, 120))
            starj = int(rng.integers(0, 5000))
            endj = starj + nt if rng.random() < 0.5 else max(0, starj - nt)
            if strings == "empty" or (strings == "mixed"
                                      and rng.random() < 0.3):
                sa = sb = ""
            else:
                sa = _CHARS[rng.integers(0, 6, nt)].tobytes().decode()
                sb = _CHARS[rng.integers(0, 6, nt)].tobytes().decode()
            hits.append(Triplex(
                stari=stari, endi=stari + nt, starj=starj, endj=endj,
                strand=int(rng.integers(0, 2)),
                reverse=int(rng.choice([-1, 1])),
                rule=int(rng.integers(1, 19)), nt=nt,
                score=np.float32(rng.uniform(20, 200)),
                identity=np.float32(rng.uniform(60, 100)),
                tri_score=np.float32(rng.uniform(1, 20)),
                stri_align=sa, strj_align=sb,
                genomestart=starj + start_genome - 1,
                genomeend=endj + start_genome - 1, chr=chro))
        out.append((chro, start_genome, hits))
    return out


CASES = {
    # name: (records, most hits a record, -C buckets, strings)
    "three_buckets": (7, 40, 3, "mixed"),
    "one_bucket": (3, 60, 1, "random"),
    "empty": (4, 0, 2, "random"),
    "empty_strings": (5, 30, 2, "empty"),
}


@pytest.mark.parametrize("spill", [True, False], ids=["spill", "ram"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_store_matches_list_path(tmp_path, capsys, case, spill):
    n_records, per_record, buckets, strings = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 11)
    recs = _records(rng, n_records, per_record, strings)
    n_hits = sum(len(h) for _, _, h in recs)
    assert (n_hits > 0) == (case != "empty")
    # the list path takes the buckets concatenated, each in record order
    tlist = [dataclasses.replace(t) for b in range(buckets)
             for ri, (_, _, hits) in enumerate(recs) if ri % buckets == b
             for t in hits]
    spill_dir = tmp_path / "spill"
    st = TriplexStore(spill_dir=str(spill_dir) if spill else None)
    for ri, (chro, _, hits) in enumerate(recs):
        st.add_record(ri % buckets, chro,
                      [dataclasses.replace(t) for t in hits])
    st.finalize()
    assert len(st) == n_hits
    first_chro, first_start = recs[0][0], recs[0][1]
    outs = {}
    for path, what in (("list", tlist), ("store", st)):
        p = Params(file1path="dna.fa", outpath=str(tmp_path / path))
        os.makedirs(p.outpath)
        writer = print_result if path == "list" else print_result_store
        writer(p, "sp", "lnc", what, first_chro, 123456, first_start,
               stdout_compat=True)
        outs[path] = capsys.readouterr().out
    if spill:
        assert os.listdir(spill_dir) == []  # close() removed the spill file
    names = sorted(os.listdir(tmp_path / "list"))
    assert names == sorted(os.listdir(tmp_path / "store")) and len(names) == 3
    for name in names:
        a = (tmp_path / "list" / name).read_bytes()
        b = (tmp_path / "store" / name).read_bytes()
        assert a == b, (case, spill, name)
    assert outs["list"] == outs["store"]
    sorted_rows = (tmp_path / "list" / names[-1]).read_text().splitlines()
    assert names[-1].endswith("TFOsorted")
    assert (len(sorted_rows) > 1) == (case != "empty")
