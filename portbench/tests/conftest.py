"""A cell small enough for the CPU: two records of 400 bases from the
MEG3 peaks a job, against the MEG3 lncRNA, on the port's CPU engine; and
the same cell through the streaming driver (`--tpu-stream on`)."""

from pathlib import Path

import pytest

from portbench import harness, traffic

BENCH = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="session")
def tiny_dna(tmp_path_factory) -> Path:
    recs = traffic.raw_records(BENCH / "data" / "meg3dna.fa")[:3]
    path = tmp_path_factory.mktemp("tiny") / "dna.fa"
    with open(path, "w") as f:
        for r in recs:
            sp, chro, rng = r.header.split("|")
            a = int(rng.split("-")[0])
            f.write(f">{sp}|{chro}|{a}-{a + 399}\n{r.text[:400]}\n")
    return path


@pytest.fixture
def tiny_cell(tiny_dna):
    """(bench, cell_spec) of a tiny cell on the CPU."""
    bench = harness.manifest()
    cell = {"name": "tiny.peaks2", "config": "tiny", "traffic": "peaks2",
            "chips": 1}
    bench["workloads"].append(cell)
    config = {"lncrna": "portbench/data/MEG3.fa", "dna": str(tiny_dna),
              "flags": []}
    mix = {"records_per_job": 2, "jobs_written": 2, "check_records": 3}
    return bench, (cell, config, mix)


@pytest.fixture
def tiny_stream_cell(tiny_cell):
    """(bench, cell_spec) of the tiny cell with `--tpu-stream on` in its
    configuration's flags: the streaming driver hands the output stage a
    TriplexStore.  It pads every batch to the cut length, so the cut is
    500 here (each 400-base record one segment, 512 columns, as the
    batched driver pads them): at the default 5,000 one run on the CPU
    engine takes over a minute."""
    bench, (cell, config, mix) = tiny_cell
    cell = dict(cell, name="tiny_stream.peaks2", config="tiny_stream")
    bench["workloads"].append(cell)
    flags = ["--tpu-stream", "on", "-c", "500", "-o", "100"]
    return bench, (cell, dict(config, flags=flags), mix)


def run_tiny(tiny_cell, seed=20260001, seconds=0.5, trace=False):
    import time

    bench, spec = tiny_cell
    return harness.run_cell(spec[0]["name"], seed, seconds, trace,
                            time.perf_counter(),
                            extra_argv=["--tpu-engine", "torch"],
                            bench=bench, cell_spec=spec, device="cpu")
