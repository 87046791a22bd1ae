"""The job generator: seeded, the same jobs for the same seed, other
groupings for other seeds, every record once a cycle, none twice in a
job."""

import itertools

import pytest

from portbench import traffic

BIG = 2**31 + 12345


def take(n, per, seed, count):
    return list(itertools.islice(
        traffic.jobs(n, per, traffic.rng(seed, traffic.WINDOW)), count))


@pytest.mark.parametrize("per", [1, 64, 128])
def test_same_seed_same_jobs_other_seed_other_jobs(per):
    assert take(532, per, BIG, 6) == take(532, per, BIG, 6)
    assert take(532, per, BIG, 6) != take(532, per, BIG + 1, 6)


@pytest.mark.parametrize("per", [1, 64, 128, 532])
def test_every_cycle_scans_each_record_once_and_no_job_repeats_one(per):
    jobs = take(532, per, 7, 40)
    for job in jobs:
        assert len(set(job)) == len(job) == per
    flat = [r for job in jobs for r in job]
    counts = {r: flat.count(r) for r in range(532)}
    assert max(counts.values()) - min(counts.values()) <= 2


def test_warm_up_window_and_sample_streams_differ():
    a = next(traffic.jobs(532, 64, traffic.rng(5, traffic.WINDOW)))
    b = next(traffic.jobs(532, 64, traffic.rng(5, traffic.WARMUP)))
    assert a != b


def test_sample_is_seeded_and_in_range():
    done = take(532, 128, 3, 5)
    s1 = traffic.sample(done, 8, traffic.rng(9, traffic.SAMPLE))
    assert s1 == traffic.sample(done, 8, traffic.rng(9, traffic.SAMPLE))
    assert len(set(s1)) == 8
    assert all(0 <= j < 5 and 0 <= k < 128 for j, k in s1)
    assert traffic.sample(done[:1], 500, traffic.rng(9, 2)) == \
        [(0, k) for k in range(128)]


def test_fasta_text_round_trips_through_the_reader(tmp_path):
    recs = traffic.raw_records(traffic.BENCH / "data" / "meg3dna.fa")
    assert len(recs) == 532
    assert sum(len(r.text) for r in recs) == 1316004
    path = tmp_path / "job.fa"
    path.write_text(traffic.fasta_text(recs, [5, 2]))
    back = traffic.raw_records(path)
    assert [(r.header, r.text) for r in back] == \
        [(recs[i].header, recs[i].text) for i in (5, 2)]


@pytest.mark.parametrize("bad", [
    {"records_per_job": 0, "jobs_written": 1, "check_records": 1},
    {"records_per_job": 2, "jobs_written": "x", "check_records": 1},
])
def test_a_malformed_mix_is_refused(tmp_path, monkeypatch, bad):
    import json

    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "bad.json").write_text(json.dumps(bad))
    monkeypatch.setattr(traffic, "BENCH", tmp_path)
    with pytest.raises(ValueError):
        traffic.load_mix("bad")
