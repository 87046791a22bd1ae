"""The share of the window's batches whose scan escalated, in percent: a
batch with a threshold >= 251 reruns its scan with full_prefix=True and
fetches its full column maxima (scan/batched.py:_process_batch), about
0.2 s of the card on a NEAT1 job.  Read from the program's counters over
the window (`n_batches_escalated` over `n_batches` in record["stages"],
profiling.STAGES.report()); None where the program does not count them.
Batched-driver layer; moves device_s_per_mbp."""


def read(rec: dict):
    stages = rec.get("stages") or {}
    batches = stages.get("n_batches", 0)
    if batches <= 0:
        return None
    return 100.0 * stages.get("n_batches_escalated", 0) / batches
