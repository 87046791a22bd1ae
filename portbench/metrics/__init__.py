"""Metrics read from a run's record, one reader a file, found by the
metric's name in BENCHMARK.json: every per-layer metric, and every
end-to-end metric but setup_s, which the harness times itself.
`read(record)` takes the run's record (see portbench/harness.py:
window_s, bases, jobs, job_s, stages, query_len, transforms, segments,
scanned, longest, trace) and returns the value, or None when the run has
nothing to read for it; the harness then leaves it out.
"""
