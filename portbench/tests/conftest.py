"""A cell small enough for the CPU: two records of 400 bases from the
MEG3 peaks a job, against the MEG3 lncRNA, on the port's CPU engine; the
same cell through the streaming driver (`--tpu-stream on`); and a cell of
eight such records a job dealt over four engines (`--tpu-dp-devices 4`)."""

from pathlib import Path

import pytest

from portbench import harness, traffic

BENCH = Path(__file__).resolve().parent.parent


def _tiny_fasta(path: Path, picks: list[int]) -> Path:
    """The first 400 bases of each picked MEG3 peak, as its own record."""
    recs = traffic.raw_records(BENCH / "data" / "meg3dna.fa")
    with open(path, "w") as f:
        for k in picks:
            sp, chro, rng = recs[k].header.split("|")
            a = int(rng.split("-")[0])
            f.write(f">{sp}|{chro}|{a}-{a + 399}\n{recs[k].text[:400]}\n")
    return path


@pytest.fixture(scope="session")
def tiny_dna(tmp_path_factory) -> Path:
    return _tiny_fasta(tmp_path_factory.mktemp("tiny") / "dna.fa", [0, 1, 2])


@pytest.fixture(scope="session")
def tiny_dp_dna(tmp_path_factory) -> Path:
    """Eight records, each with triplexes against MEG3 (1 to 7 each on
    the port's CPU engine), so that every engine's batch has hits to
    lose."""
    return _tiny_fasta(tmp_path_factory.mktemp("tiny_dp") / "dna.fa",
                       [0, 2, 4, 6, 9, 11, 12, 13])


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


@pytest.fixture
def tiny_dp4_cell(tiny_cell, tiny_dp_dna):
    """(bench, cell_spec) of a cell of eight records a job over four
    engines, two segments a batch: the job's four batches go one to each
    engine (batch k to engine k mod 4), and the check recomputes all
    eight records of the window's first job."""
    bench, (cell, config, mix) = tiny_cell
    cell = dict(cell, name="tiny_dp4.peaks8", config="tiny_dp4")
    bench["workloads"].append(cell)
    flags = ["--tpu-dp-devices", "4", "--tpu-segments-per-batch", "2"]
    mix = {"records_per_job": 8, "jobs_written": 1, "check_records": 8}
    return bench, (cell, dict(config, dna=str(tiny_dp_dna), flags=flags),
                   mix)


def run_tiny(tiny_cell, seed=20260001, seconds=0.5, trace=False):
    import time

    bench, spec = tiny_cell
    return harness.run_cell(spec[0]["name"], seed, seconds, trace,
                            time.perf_counter(),
                            extra_argv=["--tpu-engine", "torch"],
                            bench=bench, cell_spec=spec, device="cpu")
