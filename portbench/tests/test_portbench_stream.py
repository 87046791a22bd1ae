"""The check reads a streamed job's TriplexStore: its rows as the output
stage writes them (harness.store_rows), read without disturbing the
store, and a tiny cell whose configuration streams runs correct."""

import numpy as np

from portbench import check, harness

from .conftest import run_tiny


def _hits():
    from fasim_tpu_torch.scan.pipeline import Triplex

    def t(k, chro):
        return Triplex(stari=10 + k, endi=60 + k, starj=100 + 3 * k,
                       endj=150 + 3 * k, strand=k % 2, reverse=1, rule=1 + k,
                       nt=51, score=np.float32(40.5 + k),
                       identity=np.float32(77.25), tri_score=np.float32(1.5),
                       stri_align="ACGU"[k % 4] * (5 + k),
                       strj_align="TTAG"[: 1 + k % 4], genomestart=1000 + k,
                       genomeend=1050 + k, chr=chro)

    return [[t(0, "chr1"), t(1, "chr1")], [], [t(2, "chr7")]]


def _store(spill_dir):
    from fasim_tpu_torch.post.store import TriplexStore

    st = TriplexStore(spill_dir=spill_dir)
    for k, hits in enumerate(_hits()):
        st.add_record(0, hits[0].chr if hits else "chrX", hits)
    return st.finalize()


def test_store_rows_read_the_store_and_leave_it_as_it_was(tmp_path):
    from fasim_tpu_torch.post.store import write_tfosorted_store

    for spill in (str(tmp_path / "spill"), None):
        read, untouched = _store(spill), _store(spill)
        rows = harness.store_rows(read)
        want = [h for hits in _hits() for h in hits]
        assert [check.hit_of(r) for r in rows] == \
            [check.hit_of(t) for t in want]
        assert read._mm is None
        for st, name in ((read, "a"), (untouched, "b")):
            st.cols["motif"] = np.ones(len(st), np.int32)
            for f in ("middle", "center"):
                st.cols[f] = np.zeros(len(st), np.int32)
            write_tfosorted_store(str(tmp_path / name), st)
            st.close()
        assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()
        assert "ACGU"[2] * 7 in (tmp_path / "a").read_text()


def test_a_tiny_streamed_cell_is_correct(tiny_stream_cell):
    result, lines = run_tiny(tiny_stream_cell)
    assert result["correct"], lines
    assert result["failed"] == 0
    assert all(n["value"] == 0 for n in result["checks"].values())
    assert any(x.startswith("streamed stores read for the check: ")
               for x in lines), lines
