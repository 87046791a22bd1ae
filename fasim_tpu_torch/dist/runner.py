"""Multi-host distributed scan runner (counterpart of
fasim_tpu/dist/runner.py), on torch.distributed with the gloo backend.

Every process (host) streams the DNA records (one in memory at a time),
takes a round-robin shard of the global (record, segment) work stream
(work item gidx goes to process gidx % nproc), scans it on its local
engines through the bounded-window driver, and the hit lists are
allgathered and merged in global work order, so the merged result is
byte-identical to a single-host run whatever the process count or the
completion order.  Clustering and output run on process 0 only (they
are global over the RNA axis, Fasim-LongTarget.cpp:812).

Collectives: two `all_gather` rounds (the payload lengths, then the
padded payloads) of CPU tensors over gloo.  The payloads are host
pickles of Triplex lists, not device tensors, so gloo carries them
between hosts and between processes that share one card (which NCCL
refuses).

Checkpoint/resume (SURVEY.md §5): with `checkpoint_dir` set, each
process spills a pickle per `checkpoint_every` finished work items; a
restarted run reloads the spills and rescans only the rest of its shard.

Differences from fasim_tpu.dist.runner, each for a reason:

  * the spills are named `torch-host{pid}-spill*.pkl`, not
    `host{pid}-spill*.pkl`, and are read (like the gathered payloads)
    by an unpickler that resolves only the port's Triplex and numpy's
    scalar types: a JAX package's spill in the same FASIM_CKPT directory
    would otherwise import `fasim_tpu`, and with it `jax`, on load (and
    unpickling runs whatever a file names);
  * a monitored barrier with a long timeout comes before the gather, so
    the collectives' shorter timeout (RENDEZVOUS_TIMEOUT_S, which also
    bounds the rendezvous) does not cut a process that waits for a slow
    peer's scan;
  * `--tpu-engine numpy` (the per-segment path) is refused: the runner
    needs the batched driver's engines.
"""

from __future__ import annotations

import datetime
import io
import os
import pickle
import time

import numpy as np
import torch

from .. import rules
from ..config import Params
from ..io import fasta
from ..scan.batched import (RecordMeta, _Work, corenum_buckets,
                            finalize_record_into, iter_scan_work)
from ..scan.pipeline import Triplex

# wall seconds of the last local scan loop and of the last gather, per
# process (the scaling lines of `main`)
LAST_LOCAL_SECONDS = 0.0
LAST_GATHER_SECONDS = 0.0

# rendezvous and collectives: long enough for processes that start on a
# loaded box (jax.distributed's initialization timeout is 300 s too)
RENDEZVOUS_TIMEOUT_S = 300
# the barrier before the gather waits for the slowest peer's local scan
GATHER_WAIT = datetime.timedelta(days=1)

SPILL_PREFIX = "torch-host{pid}-spill"

# the only globals a payload of the port names (numpy 1.x and 2.x paths)
_PAYLOAD_GLOBALS = {
    ("fasim_tpu_torch.scan.pipeline", "Triplex"): Triplex,
    ("numpy", "dtype"): np.dtype,
    ("numpy.core.multiarray", "scalar"): None,
    ("numpy._core.multiarray", "scalar"): None,
}


class _PayloadUnpickler(pickle.Unpickler):
    """Unpickles only the port's hit payloads: any other global (a JAX
    package's Triplex, or anything a foreign file names) is refused
    before it is imported."""

    def find_class(self, module, name):
        if (module, name) not in _PAYLOAD_GLOBALS:
            raise pickle.UnpicklingError(
                f"not a fasim_tpu_torch hit payload: it names {module}.{name}")
        return super().find_class(module, name)


def _loads(blob: bytes):
    return _PayloadUnpickler(io.BytesIO(blob)).load()


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_bytes(payload: bytes) -> list[bytes]:
    """Allgather one bytes object per process via two fixed-shape
    collectives (lengths, then padded uint8 payloads)."""
    import torch.distributed as dist

    _, n = _rank_world()
    if n == 1:
        return [payload]
    buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(buf)], dtype=torch.int64))
    lens = [int(x) for x in lens]
    maxlen = max(lens)
    padded = torch.zeros(maxlen, dtype=torch.uint8)
    padded[:len(buf)] = buf
    gathered = [torch.empty(maxlen, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(gathered, padded)
    return [g[:k].numpy().tobytes() for g, k in zip(gathered, lens)]


def check_shard_coverage(expected: int, got, nproc: int) -> None:
    """Failed-shard detection: every process streams the same input, so
    process 0 knows the full global work-index set; a host that died
    mid-scan (or lost its checkpoint spills) leaves holes that would
    otherwise produce silently incomplete output.  Raises naming the
    missing shards and their owning process(es) (gidx % nproc)."""
    missing = sorted(set(range(expected)) - set(got))
    if missing:
        owners = sorted({i % nproc for i in missing})
        raise RuntimeError(
            f"distributed scan incomplete: {len(missing)}/{expected} work "
            f"items missing (first: {missing[:8]}), owned by process(es) "
            f"{owners} — rerun with the same FASIM_CKPT to rescan only "
            "the missing shards")


def _load_spills(checkpoint_dir: str, pid: int) -> dict:
    """This process's spills: {gidx: (record_idx, hits)}."""
    prefix = SPILL_PREFIX.format(pid=pid)
    hits: dict[int, tuple[int, list[Triplex]]] = {}
    for name in sorted(os.listdir(checkpoint_dir)):
        if not (name.startswith(prefix) and name.endswith(".pkl")):
            continue
        with open(os.path.join(checkpoint_dir, name), "rb") as f:
            loaded = _loads(f.read())
        if not isinstance(loaded, dict):
            raise RuntimeError(f"stale checkpoint format in {name}: clear "
                               "FASIM_CKPT and rescan")
        for gidx, payload in loaded.items():
            if (not isinstance(payload, tuple) or len(payload) != 2
                    or not isinstance(payload[0], int)):
                raise RuntimeError(
                    f"stale checkpoint format in {name}: expected "
                    "{gidx: (record_idx, hits)} spills — clear "
                    "FASIM_CKPT and rescan")
            hits[gidx] = payload
    return hits


def scan_distributed(p: Params, engine_factory, batch_pairs: int = 64,
                     host_threads: int = 0, checkpoint_dir: str | None = None,
                     checkpoint_every: int = 64, max_inflight: int = 4):
    """Run the sharded streaming scan.  Returns (record_metas, lnc_name,
    rna, all_t) on process 0 and (record_metas, lnc_name, rna, None)
    elsewhere; record_metas are `RecordMeta` (headers and lengths only).
    Without an initialized process group it runs as the only process.

    engine_factory(rna) builds the local engine or engines (a
    TorchScanEngine or a list, one a device), after the query is read.
    """
    global LAST_LOCAL_SECONDS, LAST_GATHER_SECONDS

    pid, nproc = _rank_world()
    lnc_name, rna = fasta.read_rna(p.file2path)
    engine = engine_factory(rna)
    scans = rules.scan_list(p.rule, p.strand)

    my_hits: dict[int, tuple[int, list[Triplex]]] = {}
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        my_hits = _load_spills(checkpoint_dir, pid)
    done = set(my_hits)
    metas: list[RecordMeta] = []
    n_work = [0]  # total global work items (known after the stream ends)

    def gen():
        gidx = -1
        for rec in fasta.iter_dna(p.file1path):
            metas.append(RecordMeta(rec.species, rec.chro_tag,
                                    rec.start_genome, len(rec.seq)))
            segs, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                              p.overlap_length)
            for seg, start in zip(segs, starts):
                if fasta.same_seq(seg):
                    continue
                gidx += 1
                n_work[0] = gidx + 1
                if gidx % nproc != pid or gidx in done:
                    continue
                yield _Work(len(metas) - 1, start, seg, gidx)

    n_pad = (p.cut_length + 127) // 128 * 128
    fresh: dict[int, tuple[int, list[Triplex]]] = {}
    n_spill = 0

    def spill():
        nonlocal n_spill
        prefix = SPILL_PREFIX.format(pid=pid)
        while True:  # a resumed run continues the numbering
            path = os.path.join(checkpoint_dir,
                                f"{prefix}{n_spill:06d}.pkl")
            n_spill += 1
            if not os.path.exists(path):
                break
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(fresh, f)
        os.replace(tmp, path)

    t_local = time.perf_counter()
    for w, found in iter_scan_work(p, rna, gen(), scans, engine, n_pad,
                                   batch_pairs, host_threads, max_inflight):
        fresh[w.gidx] = (w.record_idx, found)
        if checkpoint_dir and len(fresh) >= checkpoint_every:
            spill()
            my_hits.update(fresh)
            fresh = {}
    if fresh:
        if checkpoint_dir:
            spill()
        my_hits.update(fresh)
    LAST_LOCAL_SECONDS = time.perf_counter() - t_local

    t_gather = time.perf_counter()
    if nproc > 1:
        import torch.distributed as dist

        dist.monitored_barrier(timeout=GATHER_WAIT)
    gathered = _allgather_bytes(pickle.dumps(my_hits))
    LAST_GATHER_SECONDS = time.perf_counter() - t_gather
    if pid != 0:
        return metas, lnc_name, rna, None
    merged: dict[int, tuple[int, list[Triplex]]] = {}
    for blob in gathered:
        merged.update(_loads(blob))
    check_shard_coverage(n_work[0], merged.keys(), nproc)
    # final filter + coordinate fixup + `-C` bucket permutation, in
    # global (record, segment) order, through the single-host drivers'
    # helper
    buckets = corenum_buckets(p.corenum)
    per_record: dict[int, list[Triplex]] = {}
    for i in sorted(merged):
        ri, hits = merged[i]
        per_record.setdefault(ri, []).extend(hits)
    for ri in sorted(per_record):
        finalize_record_into(buckets, p, ri, metas[ri], per_record[ri])
    return metas, lnc_name, rna, [t for b in buckets for t in b]


def init_process_group() -> None:
    """gloo from FASIM_COORD (host:port), FASIM_NPROC and FASIM_PID when
    FASIM_COORD is set, else from torchrun's variables (env://)."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S)
    coord = os.environ.get("FASIM_COORD")
    if coord:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["FASIM_NPROC"]),
            rank=int(os.environ["FASIM_PID"]), timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)


def main(argv=None) -> int:
    """`python -m fasim_tpu_torch.dist.runner` with the CLI's flags: join
    the process group and run the sharded scan; process 0 writes the
    output.

    Env: FASIM_COORD (host:port), FASIM_NPROC, FASIM_PID give the
    topology (else torchrun's); FASIM_CKPT the checkpoint directory;
    FASIM_HOST_THREADS the finalize pool; FASIM_CPU_PIN pins process i
    to core i mod the core count; FASIM_SCALING_REPS > 1 repeats the
    scan and prints a FASIM_SCAN_SECONDS line a repeat.
    """
    import sys

    import torch.distributed as dist

    from ..cli import make_engine, parse_args
    from ..post.output import print_result

    if os.environ.get("FASIM_CPU_PIN"):
        # scaling harness: one core a loopback process, so the processes'
        # thread pools cannot thrash across each other
        ncpu = os.cpu_count() or 1
        os.sched_setaffinity(
            0, {int(os.environ.get("FASIM_PID", "0")) % ncpu})
    p, tpu = parse_args(sys.argv[1:] if argv is None else argv)
    if tpu.engine == "numpy":
        sys.exit("fasim_tpu_torch.dist.runner: --tpu-engine numpy is the "
                 "per-segment path; use cuda or torch")
    if tpu.sim_device:
        os.environ["FASIM_SIM_DEVICE"] = "1"
    init_process_group()
    try:
        host_threads = int(os.environ.get("FASIM_HOST_THREADS", "0"))
        reps = int(os.environ.get("FASIM_SCALING_REPS", "1"))
        for rep in range(reps):
            # rep > 0 measures the warm steady state; results are equal
            t0 = time.perf_counter()
            records, lnc_name, rna, all_t = scan_distributed(
                p, lambda r: make_engine(tpu, r),
                batch_pairs=tpu.segments_per_batch,
                host_threads=host_threads,
                checkpoint_dir=(os.environ.get("FASIM_CKPT") or None)
                if reps == 1 else None, max_inflight=tpu.max_inflight)
            if reps > 1:
                print(f"FASIM_SCAN_SECONDS rep={rep} pid={dist.get_rank()}"
                      f" total={time.perf_counter() - t0:.3f}"
                      f" local={LAST_LOCAL_SECONDS:.3f}"
                      f" gather={LAST_GATHER_SECONDS:.3f}", flush=True)
        if dist.get_rank() == 0:
            first = records[0]
            print_result(p, first.species, lnc_name, all_t, first.chro_tag,
                         first.seq_len, first.start_genome)
            print("finished normally")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
